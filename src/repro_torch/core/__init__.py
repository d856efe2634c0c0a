"""Kernel declarations, traceback and the public alignment API of the port."""
