"""Results analysis of the port: the port's results beside the DAFx-24
poster's published numbers (``compare``)."""
