"""The plain references, one a configuration's ``reference``."""
