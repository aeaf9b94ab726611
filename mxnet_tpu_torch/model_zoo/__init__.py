"""Symbol constructors of the models the port serves."""
