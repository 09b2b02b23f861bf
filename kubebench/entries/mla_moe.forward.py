"""Entry ``mla_moe.forward``: a scoring pod serving whole prompts, one
forward of ``tpukube_torch.workload.mla_moe`` a request (B=1), to the
mix's closed-loop clients, first come first served: the driver of
``llama.forward``, calling the MLA + MoE decoder.

Each client sends its next request when its last one completes; a request
is timed from when its client sent it to when its logits, and the token
each position serves next (their argmax), are complete on the device. The
request in service when the window closes is reported apart (its tokens,
its start and end of service), so that the work done inside the window
can be counted whole. A request refused by the device (out of memory)
counts as failed. Each request also keeps its float32 logits at a few
evenly spaced positions and a seeded set of vocabulary columns, and the
experts each MoE layer chose for each token (the program hands them out as
it makes them). After the window the served tokens, the kept logits and
the choices of a sample of the completed requests, the longest among
them, go back to the benchmark, which holds them against the reference.

A request replays the forward from a CUDA graph captured for its length
in set-up (``tpukube_torch.workload.graphs``; one per length of the mix),
as a server of a fixed set of lengths would: the forward's ~4,000
launches would otherwise leave the card waiting on the host, and the
cell's pace on how busy the host's cores are. A profiled request (``--trace
1``) runs the forward as it is, so that its spans and their counters show;
its lengths are run once in set-up too, after the captures, so that the
allocator's blocks for it are made there.
"""

import base64
import time
from collections import deque

import torch

from kubebench import traffic as gen
from kubebench import weights, weights_mla_moe
from tpukube_torch.workload import graphs, mla_moe


def port_config(c: dict) -> mla_moe.MlaMoeConfig:
    if c["q_lora_rank"] is not None or c["n_group"] != 1 or c["topk_group"] != 1:
        raise ValueError("mla_moe runs no query latent and no group-limited routing")
    if c["scoring_func"] != "sigmoid" or not c["norm_topk_prob"] or c["moe_layer_freq"] != 1:
        raise ValueError("mla_moe routes by sigmoid scores, renormalised, every layer")
    if c["assumed"]["latent_norm_eps"] != mla_moe.LATENT_NORM_EPS:
        raise ValueError("mla_moe's latent norm epsilon is the published code's")
    return mla_moe.MlaMoeConfig(
        vocab=c["vocab_size"], d_model=c["hidden_size"], n_layers=c["num_hidden_layers"],
        first_dense=c["first_k_dense_replace"], n_heads=c["num_attention_heads"],
        kv_rank=c["kv_lora_rank"], qk_nope_dim=c["qk_nope_head_dim"],
        qk_rope_dim=c["qk_rope_head_dim"], v_dim=c["v_head_dim"],
        d_ff_dense=c["intermediate_size"], n_experts=c["n_routed_experts"],
        top_k=c["num_experts_per_tok"], d_expert=c["moe_intermediate_size"],
        n_shared=c["n_shared_experts"], routed_scale=c["routed_scaling_factor"],
        rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"])


def run(pod) -> dict:
    t = pod.traffic
    if t["batch"] != 1:
        raise ValueError("mla_moe.forward serves one prompt a forward")
    cfg, dev = port_config(pod.config), pod.device
    params = weights_mla_moe.params(pod.config, pod.seed, dev)
    pool = weights.token_pool(pod.seed, t["token_pool"], cfg.vocab, dev)
    cols = weights_mla_moe.logit_columns(pod.seed, cfg.vocab, t["check_logit_columns"], dev)
    kept = {n: weights_mla_moe.logit_positions(n, t["check_positions_per_request"], dev)
            for n in gen.lengths(t["prompt_tokens"])}
    per_pod = t["clients_per_pod"]
    pod.mark("weights and tokens")
    clients = [gen.Client(t, pod.seed, pod.index * per_pod + c) for c in range(per_pod)]

    if cfg.n_experts > 256:
        raise ValueError("the report packs each choice in a byte")

    def serve(toks):
        routes: list = []
        out = mla_moe.forward(params, toks, cfg, routes)[0]
        # kept a byte a choice, so that what a window keeps stays small
        return (out.argmax(-1).to(torch.int32), out[kept[toks.shape[1]]][:, cols],
                torch.stack(routes).to(torch.uint8))

    lengths = sorted(set(gen.lengths(t["prompt_tokens"])), reverse=True)
    with torch.inference_mode():
        replay = graphs.ByShape(serve, [pool[:n][None] for n in lengths])
        pod.mark(f"{len(replay.shapes)} graphs captured")
        if pod.tracer.on:
            # the longest first, after the captures (each empties the
            # allocator's cache)
            for n in lengths:
                serve(pool[:n][None])
        pod.sync()
        t0, t1 = pod.ready({"params": sum(p.numel() for p in weights.named(params).values())})
        queue = deque((c, clients[c].next(), t0) for c in range(per_pod))
        done, served, failed, straddle = [], [], 0, None
        while True:
            c, req, sent = queue.popleft()
            now = time.monotonic()
            if now >= t1:
                break
            traced = pod.tracer.begin_unit(now, dev)
            toks = pool[req.offset:req.offset + req.length][None]
            try:
                # a replay's outputs are the graph's own: the next replay
                # of that length overwrites them
                answer = serve(toks) if traced else tuple(a.clone() for a in replay(toks))
                pod.sync()
            except torch.OutOfMemoryError:
                failed += 1
                torch.cuda.empty_cache()
                end = time.monotonic()
            else:
                end = time.monotonic()
                if end <= t1:
                    done.append((req, sent, end))
                    served.append(answer)
                    if traced:
                        pod.tracer.units.append({"length": req.length})
                else:  # served across the window's close
                    straddle = [req.length, now, end]
            queue.append((c, clients[c].next(), end))
        pod.tracer.close()
    reqs = [r for r, _, _ in done]
    sample = gen.check_sample(reqs, gen.subseed(pod.seed, 3, pod.index),
                              t["check_requests_per_pod"])
    index = {(r.client, r.index): i for i, r in enumerate(reqs)}
    checked = []
    for r in sample:
        tokens, logits, routes = served[index[(r.client, r.index)]]
        packed = routes.cpu().numpy().tobytes()
        checked.append({"client": r.client, "index": r.index, "length": r.length,
                        "offset": r.offset, "served": tokens.tolist(),
                        "positions": kept[r.length].tolist(), "logits": logits.tolist(),
                        "routes": base64.b64encode(packed).decode("ascii")})
    return {
        "completed": [[r.client, r.index, r.length, r.offset, a, b] for r, a, b in done],
        "attempted": len(done) + failed,
        "failed": failed,
        "straddle": straddle,
        "logit_columns": cols.tolist(),
        "sample": checked,
    }
