"""Functional layers (see `layers`)."""
