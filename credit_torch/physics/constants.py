"""Physical constants (port of credit_tpu/physics/constants.py; the values
of the reference's credit/physics_constants.py)."""

RAD_EARTH = 6371000.0  # m
RVGAS = 461.5  # J/kg/K
RDGAS = 287.05  # J/kg/K
EPSGAS = RDGAS / RVGAS
GRAVITY = 9.80665  # m/s^2
RHO_WATER = 1000.0  # kg/m^3
LH_WATER = 2.501e6  # J/kg
CP_DRY = 1004.64  # J/kg/K
CP_VAPOR = 1810.0  # J/kg/K
