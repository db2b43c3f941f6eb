"""Host utilities of the port: config, wire, runner, serving, weights."""
