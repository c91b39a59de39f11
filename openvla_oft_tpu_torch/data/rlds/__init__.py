"""RLDS episode data on the host, without TensorFlow (the port of `openvla_oft_tpu/data/rlds/`)."""
