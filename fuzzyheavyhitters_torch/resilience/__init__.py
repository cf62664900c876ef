"""Retry and deadline policy of the control plane (``policy``)."""
