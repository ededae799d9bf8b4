"""Observability layouts the port's round writes (flight ring, hist banks)."""
