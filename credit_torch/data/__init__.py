"""The port's data pipeline: the channel layout, the Normalizer, the zarr
and netCDF readers, the CF clock, the datasets, the sampler, prefetch and
replay (port of credit_tpu/data)."""
