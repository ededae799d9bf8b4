"""Host-side helpers shared by the port's device code."""
