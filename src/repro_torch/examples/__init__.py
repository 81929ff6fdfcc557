"""The port's twins of the repository's examples (``examples/``)."""
