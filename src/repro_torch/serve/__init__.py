"""Serving: ``engine`` holds the prefill / decode factories and the
greedy generation loop of the LM family."""
