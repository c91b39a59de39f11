"""The robot eval clients, one subpackage per platform, over the port's
`serving/openvla_utils.py` and `serving/robot_utils.py`."""
