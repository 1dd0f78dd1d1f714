"""Planner pieces the port needs (copies from ``repro.core``)."""
