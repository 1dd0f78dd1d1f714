"""Model code of the port (paged serve path of the dense decoder)."""
