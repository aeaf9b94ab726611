"""The examples' shared argument parsing, data iterators and training
entry point."""
