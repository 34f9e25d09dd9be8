"""Utilities of the port: device selection and the weight bridge."""
