"""Test support (fault injection); the search stack never imports it, it
only exposes the seams (``search/guards.py:_FAULT_HOOKS``) filled here."""
