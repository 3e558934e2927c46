"""Operation counts and the card's peaks, for the per-layer rooflines."""
