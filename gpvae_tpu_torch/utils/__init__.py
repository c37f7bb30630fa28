"""Utilities of the port: PNG artifacts (:mod:`.plotting`)."""
