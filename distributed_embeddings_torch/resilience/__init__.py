"""Resilience helpers of the port: fault injection (``faultinject``)."""
