"""Host-side utilities of the port (netCDF IO, seeding)."""
