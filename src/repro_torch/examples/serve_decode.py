"""Continuous-batching serving example on the EP-native engine.

Submits a burst of Poisson-arriving requests to :class:`ServingEngine`,
runs the scheduler loop (chunked prefill interleaved with decode over a
paged KV cache, every microbatch's MoE layers dispatched through ONE
persistent EP session), and prints per-request latencies measured on the
deterministic event clock.  The counterpart of the reference's
``examples/serve_decode.py``, at its geometry; the experts compute on the
card (``grouped_swiglu``) unless ``--device cpu``.

  python -m repro_torch.examples.serve_decode [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.serving import EngineConfig, ServingEngine, poisson_arrivals


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = EngineConfig(n_layers=4, n_experts=16, top_k=2, d_model=32,
                       d_ff=64, ep_degree=4, token_budget=32,
                       prefill_chunk=16, block_size=16, n_blocks=256,
                       step_mode="pipelined", nonmoe_us=12.0, seed=0)
    engine = ServingEngine(cfg, device=args.device)
    reqs = poisson_arrivals(rate_rps=50000.0, n=16, seed=3,
                            prompt_len=(8, 32), gen_len=(4, 16))
    engine.submit_all(reqs)
    stats = engine.run()

    print(f"[serve] {stats['generated_tokens']} tokens over "
          f"{stats['steps']} microbatches in "
          f"{stats['elapsed_us'] / 1e3:.1f} ms event-clock "
          f"({stats['tokens_per_s']:.0f} tok/s); "
          f"{stats['drains']} transport drains, "
          f"{stats['dispatch_wire_bytes']} dispatch wire bytes")
    print(f"[serve] TTFT p50/p99: {stats['ttft_p50_us']:.0f}/"
          f"{stats['ttft_p99_us']:.0f} us; inter-token p50/p99: "
          f"{stats['itl_p50_us']:.0f}/{stats['itl_p99_us']:.0f} us")
    print(f"{'rid':>4} {'arrive_us':>10} {'ttft_us':>9} "
          f"{'finish_us':>10} {'tokens':>6}")
    for rid in sorted(engine.sched.finished):
        st = engine.sched.finished[rid]
        print(f"{rid:>4} {st.req.arrival_us:>10.1f} "
              f"{st.first_token_us - st.req.arrival_us:>9.1f} "
              f"{st.finish_us:>10.1f} {st.generated:>6}")
    assert stats["sched_completed"] == len(reqs)
    print("[serve] OK")
    return stats


if __name__ == "__main__":
    main()
