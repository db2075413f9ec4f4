"""Networks of the port, with the reference's state_dict key names."""
