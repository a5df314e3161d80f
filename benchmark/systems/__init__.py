"""Builders of the program under test, one a configuration's ``system``."""
