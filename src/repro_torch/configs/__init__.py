"""Architecture configs of the port: the registry and the archs the
port serves so far (``llama3.2-1b``)."""
