"""Models of the port: configs to modules (``archs.build_model``), the
decoder stack (``transformer``), its layers and attention, and inputs."""
