"""Port of the matching `openvla_oft_tpu` subpackage."""
