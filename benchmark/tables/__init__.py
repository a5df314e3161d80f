"""Generators of tables from the seed, one a grid's ``generator``."""
