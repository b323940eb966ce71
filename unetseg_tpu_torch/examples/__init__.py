"""Demos of the port's public API, each runnable with ``python -m``:
``end_to_end`` (train, checkpoint, serve, evaluate), ``service_client``
(the TCP service driven as a client) and ``cascade_tiers`` (the
``disagree`` cascade and the ``json`` artifact tier)."""
