"""Traffic mixes: ``<name>.json`` data files read by ``generator.py``."""
