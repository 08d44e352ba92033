"""Host utilities of the port (``utils/file_utils.py``: remote checkpoint sync)."""
