"""fused_vq_matmul_roofline: B1's bound over its device time in the traced
ticks, %. Every decode step runs the four VQ linears of every layer at M
= the engine's slots (the decode graph runs every slot); the bound is
``bench.counts.b1_bound_ms`` (chip_smoke's count, fp32 rate). The time
is every B1 function's (its split reduce too), over the traced decode
ticks whose trace holds B1's four launches a layer (``trace.complete``);
silent where fewer than half do: the calls' shapes are then not known."""
from bench import counts
from bench.trace import complete, kernel_of

KERNEL = "fused_vq_matmul"


def read(run):
    if run.trace is None:
        return None
    cfg, M = run.cfg, run.cell.workload["engine"]["num_slots"]
    per_step = 4 * cfg["num_hidden_layers"]
    ticks = complete([t for t in run.trace.ticks if t.info.attended], KERNEL,
                     lambda t: per_step)
    if not ticks:
        return None
    spent = sum(t.seconds(lambda o: kernel_of(o.label) == KERNEL)
                for t in ticks)
    bound = len(ticks) * counts.layer_bound_ms(cfg, M) * \
        cfg["num_hidden_layers"] * 1e-3
    return bound / spent * 100.0
