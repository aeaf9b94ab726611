"""Times the port's box kernels (N1, M1) and the box ops around them in
one source tree, on one CUDA card, for an A/B of two trees in one call.

    python3 tools/torch_box_ab.py <root> <tag>

imports ``mxnet_tpu_torch`` from ``<root>`` (a checkout of the repo, or
a ``git archive`` of another commit unpacked into an ignored directory)
and the inputs and the timer (``chip_smoke.ssd_sorted_boxes``,
``time_ms``: device ms, the median of 5 runs) from this script's own
checkout, so both trees see the same boxes. Prints one JSON line: N1 at
each case (ms, its route and group, keep bits that differ from
``greedy_nms_keep_plain``; where n1_prep ranks the boxes itself, the
same with ``n1_order``'s sort instead, in a tree whose entry takes
that), ``n1_order`` alone, M1's walk, and ``MultiBoxTarget``,
``MultiBoxDetection`` (``nms_topk`` 400 and -1) and ``Proposal`` at
their users' sizes. Run it as parent, change, change,
parent, each in a process of its own, and compare within the call.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, images, boxes, threshold, force_suppress, classes)
N1_CASES = (("ssd300", 32, 8732, 0.45, False, 21),
            ("proposal", 1, 6000, 0.7, True, 21),
            ("example", 32, 320, 0.45, False, 21),
            ("detection_top400", 32, 400, 0.45, False, 21),
            ("example_forced", 32, 320, 0.45, True, 21),
            ("ssd300_forced", 32, 8732, 0.45, True, 21),
            ("ssd300_one_class", 32, 8732, 0.45, False, 1),
            ("forced_past_mask_budget", 1, 24000, 0.7, True, 21))


def main(root, tag):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "box_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import mxnet_tpu_torch as mt
    if not mt.__file__.startswith(root):
        sys.exit(f"mxnet_tpu_torch came from {mt.__file__}, not {root}")
    from mxnet_tpu_torch.kernels import build
    from mxnet_tpu_torch.ops import nms
    from mxnet_tpu_torch.ops.registry import get_op
    build.load("greedy_nms")
    dev = "cuda:0"
    out = {"tag": tag, "root": root, "n1": {}, "n1_order_ms": {}}
    gen = torch.Generator(device=dev)
    for name, b, n, th, force, classes in N1_CASES:
        gen.manual_seed(cs.SEED + 23)
        boxes, ids, valid = cs.ssd_sorted_boxes(torch, gen, b, n)
        if classes == 1:
            ids = torch.zeros_like(ids)
        args = (boxes, ids, valid, th, force)
        keep = nms.greedy_nms_keep(*args)
        mism = int((keep != nms.greedy_nms_keep_plain(*args)).sum())
        try:
            plan = nms._n1_plan(boxes.device, b, n, force)
        except TypeError:                   # a tree whose plan has no force
            plan = nms._n1_plan(boxes.device, b, n)
        order_form = getattr(plan, "order", None)
        out["n1"][name] = {
            "shape": [b, n], "force_suppress": force, "classes": classes,
            "route": getattr(plan, "route", None), "order": order_form,
            "group": getattr(plan, "group", None),
            "mismatches": mism,
            "ms": cs.time_ms(lambda: nms.greedy_nms_keep(*args), reps=5,
                             inner=3, warmup=1)}
        if hasattr(nms, "n1_order"):
            out["n1_order_ms"][name] = cs.time_ms(
                lambda: nms.n1_order(ids, valid, force), reps=5, inner=3,
                warmup=1)
        if order_form == "rank":
            # the same call with the boxes ordered by n1_order's sort
            rank_max = nms._N1_RANK_MAX
            nms._N1_RANK_MAX = 0
            nms._n1_plan.cache_clear()
            try:
                keep = nms.greedy_nms_keep(*args)
                out["n1"][name]["sort_order"] = {
                    "mismatches": int((keep != nms.greedy_nms_keep_plain(
                        *args)).sum()),
                    "ms": cs.time_ms(lambda: nms.greedy_nms_keep(*args),
                                     reps=5, inner=3, warmup=1)}
            except mt.MXNetError as e:      # an entry that refuses it
                out["n1"][name]["sort_order"] = {"error": str(e)}
            finally:
                nms._N1_RANK_MAX = rank_max
                nms._n1_plan.cache_clear()
    b, n, m = cs.SSD_M1_CASE
    gen.manual_seed(cs.SEED + 24)
    s = torch.round(torch.rand(b, n * m, device=dev, generator=gen)
                    * 100) / 100
    order = torch.sort(s, dim=1, stable=True).indices.flip(1).contiguous()
    out["m1_walk_ms"] = cs.time_ms(
        lambda: nms.bipartite_match(s, order, n, m, n * m, 0.5, False),
        reps=5, inner=5, warmup=1)
    # SSD300 on VOC at batch 32 with 50 label slots, 6 of them used
    gen.manual_seed(cs.SEED + 231)
    t = cs.SSD_TIMING
    a, bb, c, lab = t["anchors"], t["batch"], t["classes"], t["L"]
    xy = torch.rand(a, 2, device=dev, generator=gen) * 0.9
    anchor = torch.cat([xy, xy + 0.02 + torch.rand(
        a, 2, device=dev, generator=gen) * 0.5], 1)[None]
    label = torch.full((bb, lab, 5), -1.0, device=dev)
    lxy = torch.rand(bb, 6, 2, device=dev, generator=gen) * 0.7
    label[:, :6, 1:] = torch.cat([lxy, lxy + 0.05 + torch.rand(
        bb, 6, 2, device=dev, generator=gen) * 0.25], -1)
    label[:, :6, 0] = torch.randint(0, c - 1, (bb, 6), device=dev,
                                    generator=gen).float()
    logits = torch.randn(bb, c, a, device=dev, generator=gen)
    mbt = get_op("MultiBoxTarget").fn
    out["MultiBoxTarget_ms"] = cs.time_ms(
        lambda: mbt(anchor, label, logits, negative_mining_ratio=3.0),
        reps=5, inner=3, warmup=1)
    prob = torch.softmax(logits, dim=1)
    loc = 0.2 * torch.randn(bb, a * 4, device=dev, generator=gen)
    mbd = get_op("MultiBoxDetection").fn
    for topk in (400, -1):
        out[f"MultiBoxDetection_{topk}_ms"] = cs.time_ms(
            lambda: mbd(prob, loc, anchor, nms_threshold=0.45,
                        nms_topk=topk), reps=5, inner=3, warmup=1)
        out[f"MultiBoxDetection_{topk}_peak_extra_mb"] = cs.peak_extra_mb(
            torch, lambda: mbd(prob, loc, anchor, nms_threshold=0.45,
                               nms_topk=topk))
    pb, pa, ph, pw = t["proposal"]
    rpn = torch.randn(pb, 2, pa, ph, pw, device=dev, generator=gen)
    cls_prob = torch.softmax(rpn, dim=1).reshape(pb, 2 * pa, ph, pw)
    deltas = 0.1 * torch.randn(pb, 4 * pa, ph, pw, device=dev,
                               generator=gen)
    info = torch.tensor([[600.0, 800.0, 1.0]], device=dev).repeat(pb, 1)
    prop = get_op("Proposal").fn
    out["Proposal_ms"] = cs.time_ms(lambda: prop(cls_prob, deltas, info),
                                    reps=5, inner=3, warmup=1)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out["torch"] = torch.__version__
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
