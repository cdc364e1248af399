"""Models of the port: shared layers, parameter specs, the Wan I2V stages."""
