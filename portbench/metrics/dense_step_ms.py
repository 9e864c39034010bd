"""Dense generate's decode step (``engine/generate.py``,
``engine/speculative.py``, ``engine/device_loop.py``): the rows' decode
wall over the decode steps, in ms; steps are the B1 and B2 launches over
the layer count, over the window's rounds."""


def read(run):
    if run["traffic"]["kv"] != "dense":
        return None
    L = run["config"]["num_hidden_layers"]
    steps = sum(r["launches"].get("decode_attention", 0)
                + r["launches"].get("decode_attention_mq", 0) for r in run["rounds"]) / L
    if not steps:
        return None
    decode = sum(sum(x["decode_s"] for x in r["rows"]) for r in run["rounds"])
    return 1e3 * decode / steps
