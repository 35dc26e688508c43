"""Data contracts of the port (channel layout)."""
