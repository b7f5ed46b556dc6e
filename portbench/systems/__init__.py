"""Systems under test: one module per configuration's ``system`` key."""
