"""Experiment scripts run on the card (ports of the matching `vla_scripts/` files)."""
