"""The whole round's share of the bf16 peak: the model operations of the
round's useful tokens (``roofline.prompt_flops`` once for each distinct
prompt, from the first position no row of it found in the prefix cache;
``roofline.decode_flops`` for each row's generated tokens; padding and
rejected verify positions are not counted) over the rounds'
walls times 989 TFLOP/s, in %."""

from portbench import roofline


def read(run):
    cfg, flops, wall = run["config"], 0.0, 0.0
    for r in run["rounds"]:
        for n, cached in r["prompts"]:
            flops += roofline.prompt_flops(cfg, n, cached)
        for x in r["rows"]:
            flops += roofline.decode_flops(cfg, x["input_tokens"], x["output_tokens"])
        wall += r["wall_s"]
    if not wall:
        return None
    return 100.0 * flops / (wall * roofline.PEAK_FLOPS["bfloat16"])
