"""Probes of the card that the port's bounds are held against."""
