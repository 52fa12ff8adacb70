"""Run parameters and device selection."""
