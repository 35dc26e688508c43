"""Physics of the port (port of credit_tpu/physics): constants and the
column thermodynamics the conservation fixers use."""
