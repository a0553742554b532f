"""Synthetic data: the reference corpus generator (numpy) and the planted
index generator the chip smoke test runs on."""
