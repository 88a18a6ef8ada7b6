"""Continuous-batching serving on the port: the slot-pool engine
(``engine``), the FIFO admission queue (``scheduler``) and the in-process
``ServingEngine`` (``server``)."""
