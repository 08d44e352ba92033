"""Host-side data helpers: port of the parts of ``colxlip_tpu/data`` that serving and eval use."""
