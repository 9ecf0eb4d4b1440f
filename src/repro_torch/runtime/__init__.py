"""Serving runtime: ``Request`` and ``ServeEngine`` over the engine's ``SlotLoop``."""
