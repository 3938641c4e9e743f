"""Serving: ``engine`` holds the prefill / decode factories, the greedy
generation loop of the LM family and the compiled decode-session path;
``protocol`` is the fleet's wire format (a copy of the reference's);
``fleet`` the async program server and its executor workers."""
