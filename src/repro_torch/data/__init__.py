"""The deterministic data pipeline (the port's ``repro/data``)."""
