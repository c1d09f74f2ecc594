"""Engine (``engine/engine.py``): prefill milliseconds in the window per
thousand prompt tokens prefilled (``stats["prefill_s"]``, each prefill
ending at a host read of its first token). Moves ``serve_tok_s``."""


def read(run):
    stats = run.get("stats")
    if not stats or not run["prompt_tokens"]:
        return None
    return 1e3 * stats["prefill_s"] / (run["prompt_tokens"] / 1e3)
