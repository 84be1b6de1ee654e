"""Plain references, one module per model family, named by a
configuration's ``reference`` key."""
