"""Measurement tools of the port, run as scripts on a machine with a card."""
