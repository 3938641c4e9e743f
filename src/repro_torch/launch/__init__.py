"""Launchers: ``serve`` drives the LM serving path end to end."""
