"""Traffic generators, one a kind (``<kind>.py``), and the mixes they read
(``<mix>.json``: parameters only)."""
