"""Verification and state-conversion helpers."""
