"""Measurement tools of the port (run as modules on a card)."""
