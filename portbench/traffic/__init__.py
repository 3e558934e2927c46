"""Seeded text traffic: the mixes under traffic/*.json and one generator."""
