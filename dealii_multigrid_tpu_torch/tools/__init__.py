"""Probes of the port on the card, run as scripts (see each module)."""
