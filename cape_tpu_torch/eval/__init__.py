"""Decode wrapper and prediction extraction of the serving path."""
