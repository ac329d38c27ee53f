"""Domain models: materials, geometry, accelerometer, Problem."""
