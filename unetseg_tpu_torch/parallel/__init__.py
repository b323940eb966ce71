"""Sliding windows at native resolution and the TTA ensemble, on one card."""
