"""serve_tokens_per_s: generated tokens completed in the window over the
window's seconds (the window closes when its last batch returns)."""


def read(rec):
    if rec.kind != "serve" or not rec.tokens:
        return None
    return rec.tokens / rec.window_s
