"""Entry ``llama.forward``: a scoring pod serving whole prompts, one
forward of ``tpukube_torch.workload.llama`` a request (B=1), to the mix's
closed-loop clients, first come first served.

Each client sends its next request when its last one completes; a request
is timed from when its client sent it to when its logits, and the token
each position serves next (their argmax), are complete on the device. The
request in service when the window closes is reported apart (its tokens,
its start and end of service), so that the work done inside the window
can be counted whole. A request refused by the device (out of memory under the share's quota)
counts as failed. After the window the served tokens of a sample of the
completed requests, the longest among them, go back to the benchmark,
which holds them against the reference.
"""

import time
from collections import deque

import torch

from kubebench import traffic as gen
from kubebench import weights
from tpukube_torch.workload import llama


def port_config(c: dict) -> llama.LlamaConfig:
    if c["hidden_size"] // c["num_attention_heads"] != c["assumed"]["head_dim"]:
        raise ValueError("head_dim is not hidden_size / num_attention_heads")
    return llama.LlamaConfig(
        vocab=c["vocab_size"], d_model=c["hidden_size"], n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], max_seq=c["max_position_embeddings"],
        rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"])


def run(pod) -> dict:
    t = pod.traffic
    if t["batch"] != 1:
        raise ValueError("llama.forward serves one prompt a forward")
    cfg, dev = port_config(pod.config), pod.device
    params = weights.decoder_params(pod.config, pod.seed, dev)
    pool = weights.token_pool(pod.seed, t["token_pool"], cfg.vocab, dev)
    per_pod = t["clients_per_pod"]
    pod.mark("weights and tokens")
    clients = [gen.Client(t, pod.seed, pod.index * per_pod + c) for c in range(per_pod)]

    def serve(req):
        toks = pool[req.offset:req.offset + req.length][None]
        out = llama.forward(params, toks, cfg)
        return out[0].argmax(-1).to(torch.int32)

    with torch.inference_mode():
        # every length of the mix once, the longest first, so the
        # allocator's blocks are made in set-up
        for n in sorted(set(gen.lengths(t["prompt_tokens"])), reverse=True):
            serve(gen.Request(0, 0, n, 0))
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
            try:
                tokens = serve(req)
                pod.sync()
            except torch.OutOfMemoryError:
                failed += 1
                torch.cuda.empty_cache()
                end = time.monotonic()
            else:
                end = time.monotonic()
                if end <= t1:
                    done.append((req, sent, end))
                    served.append(tokens)
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
    return {
        "completed": [[r.client, r.index, r.length, r.offset, a, b] for r, a, b in done],
        "attempted": len(done) + failed,
        "failed": failed,
        "straddle": straddle,
        "sample": [{"client": r.client, "index": r.index, "length": r.length,
                    "offset": r.offset, "served": served[index[(r.client, r.index)]].tolist()}
                   for r in sample],
    }
