"""Variable metadata: CF attributes for netCDF outputs (the port's own copy
of credit_tpu/metadata.py).

Re-implements the reference's metadata registry
(reference: credit/metadata/era5.yaml + output.py attaches
standard_name/long_name/units per variable when writing forecasts). The
table is code (no YAML dependency at runtime) and extensible via config
`metadata: {VAR: {units: ..., ...}}`.
"""

from __future__ import annotations

from typing import Dict

# reference: credit/metadata/era5.yaml (subset: the gen2 example configs'
# variables; unknown variables simply get no attributes)
ERA5_ATTRS: Dict[str, Dict[str, str]] = {
    "T": {"standard_name": "air_temperature", "long_name": "Temperature",
          "units": "K"},
    "Q": {"standard_name": "specific_humidity",
          "long_name": "Specific humidity", "units": "kg kg**-1"},
    "U": {"standard_name": "eastward_wind",
          "long_name": "U component of wind", "units": "m s**-1"},
    "V": {"standard_name": "northward_wind",
          "long_name": "V component of wind", "units": "m s**-1"},
    "W": {"standard_name": "lagrangian_tendency_of_air_pressure",
          "long_name": "Vertical velocity", "units": "Pa s**-1"},
    "SP": {"standard_name": "surface_air_pressure",
           "long_name": "Surface pressure", "units": "Pa"},
    "VAR_2T": {"standard_name": "air_temperature",
               "long_name": "2 metre temperature", "units": "K"},
    "VAR_10U": {"standard_name": "eastward_wind",
                "long_name": "10 metre U wind component", "units": "m s**-1"},
    "VAR_10V": {"standard_name": "northward_wind",
                "long_name": "10 metre V wind component", "units": "m s**-1"},
    "total_precipitation": {"standard_name": "precipitation_amount",
                            "long_name": "Total precipitation", "units": "m"},
    "evaporation": {"standard_name": "lwe_thickness_of_water_evaporation_amount",
                    "long_name": "Evaporation", "units": "m of water equivalent"},
    "mean_sea_level_pressure": {
        "standard_name": "air_pressure_at_mean_sea_level",
        "long_name": "Mean sea level pressure", "units": "Pa"},
    "geopotential": {"standard_name": "geopotential",
                     "long_name": "Geopotential", "units": "m**2 s**-2"},
    "Z500": {"standard_name": "geopotential",
             "long_name": "500 hPa geopotential", "units": "m**2 s**-2"},
    "tsi": {"standard_name": "toa_incoming_shortwave_flux",
            "long_name": "Total solar irradiance", "units": "W m**-2"},
    "toa_incident_solar_radiation": {
        "standard_name": "toa_incoming_shortwave_flux",
        "long_name": "TOA incident solar radiation", "units": "J m**-2"},
    "land_sea_mask": {"standard_name": "land_binary_mask",
                      "long_name": "Land-sea mask", "units": "1"},
    "lsm": {"standard_name": "land_binary_mask",
            "long_name": "Land-sea mask", "units": "1"},
    "surface_pressure": {"standard_name": "surface_air_pressure",
                         "long_name": "Surface pressure", "units": "Pa"},
    "temperature": {"standard_name": "air_temperature",
                    "long_name": "Temperature", "units": "K"},
    "specific_humidity": {"standard_name": "specific_humidity",
                          "long_name": "Specific humidity",
                          "units": "kg kg**-1"},
}


def variable_attrs(name: str, conf: dict = None) -> Dict[str, str]:
    """CF attributes for a (base) variable name; config `metadata:` entries
    override the built-in ERA5 table."""
    base = name.rpartition("_L")[0] or name
    attrs = dict(ERA5_ATTRS.get(base, ERA5_ATTRS.get(name, {})))
    user = ((conf or {}).get("metadata") or {})
    attrs.update(user.get(base, user.get(name, {})))
    return attrs
