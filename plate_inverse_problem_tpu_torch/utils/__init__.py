"""Small host helpers."""
