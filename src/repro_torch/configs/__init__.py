"""Architecture configs of the port: the registry, the arch the port
serves (``llama3.2-1b``) and the archs it compiles and decodes through
compiled sessions (``mamba2-780m``, ``jamba-v0.1-52b``)."""
