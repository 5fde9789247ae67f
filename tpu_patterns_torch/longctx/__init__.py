"""Long-context attention: the dense twins, the flash kernels' tile model
and the fused flash kernels (forward, and dq/dk/dv backward)."""
