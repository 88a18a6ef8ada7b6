"""Host-side accounting helpers (the port's ``utils/flops.py``)."""
