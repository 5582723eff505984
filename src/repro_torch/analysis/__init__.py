"""Reporting helpers of the port (pure Python)."""
