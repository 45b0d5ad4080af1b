"""Gossip collectives and wire codecs."""
