"""engine.prefill_pad_share: the share of the tokens the window's prefill
steps ran that were padding, %: (Δ``prefill_bucket_tokens`` −
Δ``prefill_prompt_tokens``) / Δ``prefill_bucket_tokens`` (``EngineMetrics``;
a step runs at its prompt's power-of-two length bucket). Silent where
the program has no such counter, or the window prefilled nothing."""


def read(run):
    a, b = run.counters_open, run.counters_close
    if "prefill_bucket_tokens" not in b:
        return None
    ran = b["prefill_bucket_tokens"] - a["prefill_bucket_tokens"]
    true = b["prefill_prompt_tokens"] - a["prefill_prompt_tokens"]
    return (ran - true) / ran * 100.0 if ran else None
