"""Event layers of the port: specs, state and the network assembly."""
