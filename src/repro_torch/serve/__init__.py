"""Serving: ``engine`` holds the prefill / decode factories, the greedy
generation loop of the LM and SSM families and the compiled
decode-session path; ``protocol`` is the fleet's wire format (a copy of
the reference's); ``fleet`` the async program server and its executor
workers."""
from repro_torch.serve.engine import (
    ServeState,
    greedy_generate,
    make_decode_fn,
    make_prefill_fn,
)

__all__ = ["ServeState", "greedy_generate", "make_decode_fn",
           "make_prefill_fn"]
