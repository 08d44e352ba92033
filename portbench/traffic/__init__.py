"""Traffic kinds: one module a kind, found by the name a workload file gives
under ``kind``. Each module has ``Kind(cell, device, fault=None)`` with
``setup()``, ``window(tracer)``, ``release()`` and ``readings()``."""
