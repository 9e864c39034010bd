"""B1 and B2 (``ops/decode_attention.py``) against their roofline: the
least time the traced rounds' dense attention launches could take
(``roofline.dense_attention_bound_s``) over the device time of those
kernels and of their split-KV combine, in %."""

from portbench import roofline


def read(run):
    trace = run.get("trace")
    if not trace or run["traffic"]["kv"] != "dense":
        return None
    device = sum(s for n, s in trace["device_ops"] if roofline.attention_kind(n) in ("dense", "combine"))
    L = run["config"]["num_hidden_layers"]
    bound = sum(
        roofline.dense_attention_bound_s(
            run["config"], r["rows"], r["launches"].get("decode_attention", 0) // L,
            r["launches"].get("decode_attention_mq", 0) // L, run["gamma"])
        for r in run["rounds"] if r["traced"])
    if not device or not bound:
        return None
    return 100.0 * bound / device
