"""Training of the port: state, steps, schedules and the epoch loop."""
