"""The batcher's decode step (``engine/scheduler.py``): its decode wall
over its decode steps, in ms; steps are the B3 and B4 launches over the
layer count, over the window's rounds."""


def read(run):
    if run["traffic"]["kv"] != "paged":
        return None
    L = run["config"]["num_hidden_layers"]
    steps = sum(r["launches"].get("paged_decode_attention", 0)
                + r["launches"].get("paged_decode_attention_mq", 0) for r in run["rounds"]) / L
    if not steps:
        return None
    decode = sum(sum(x["decode_s"] for x in r["rows"]) for r in run["rounds"])
    return 1e3 * decode / steps
