"""Data made from the seed."""
