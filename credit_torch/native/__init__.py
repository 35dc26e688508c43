"""Native host code of the port: `fastload`, the threaded zarr chunk
reader and decoder (a C++ library built with g++ at first use)."""
