"""One module a flow: each builds, warms and drives one entry of the
program (``Flow``), and compares a request's outputs with the plain
reference."""
