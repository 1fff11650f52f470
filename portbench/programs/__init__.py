"""One module per configuration: the port's instance, made through its
public API from the configuration's numbers and the harness's data."""
