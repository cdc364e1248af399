"""Serving launcher: stand up a complete OnePiece Workflow Set on the card
and push requests through it.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 2
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow dag
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow a2v
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch chatglm3-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch gemma3-27b --max-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch internvl2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch deepseek-67b
    PYTHONPATH=src python -m repro_torch.launch.serve --workflow llm --llm-arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --profile small --device cpu

Workflows (docs/workflows.md, docs/disaggregation.md):
  * chain — the Wan I2V pipeline as a linear 4-stage chain (text -> vae ->
            dit -> decode);
  * dag   — the paper's real Wan2.1 topology: text encoder ∥ image/VAE
            encoder as independent branches joining into the DiT;
  * a2v   — audio-to-video: asr -> (llm -> text_encode) ∥ image_encode
            -> diffusion -> vae_decode, a nested two-branch DAG whose toy
            asr and llm stages (numpy) feed the real Wan DAG;
  * llm   — disaggregated prefill/decode LLM serving: prefill ships each
            request's KV cache (rwkv6: its recurrent state; zamba2: its
            Mamba2 states and its shared block's KV caches) as KVPages over
            the fabric into a continuous-batching decode stage; every token
            stream is checked against the engine's own ``generate``.
            whisper-large-v3 is refused with the engine's
            ``NotImplementedError``: its cache holds each request's cross
            K/V and has no slot batch, as in the JAX package (it serves
            through ``ServingEngine.generate``).

Profiles: ``port`` (the default) is the size served on one H100 — for the
Wan workflows FULL's widths at cut depth, for ``llm`` the model at full
width in bfloat16, at full depth but for deepseek-67b (38 of 95 layers,
``configs.port_config``); ``small`` is the CPU-sized parity profile (for
``llm`` the reduced float32 config).

Each instance's inbox ring is sized from the configuration's largest stage
payload: at ``port`` widths a diffusion-stage message is about 13 MB, more
than the 4 MiB default ring, and a message that does not fit is dropped
(§9).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster import Rejected, StageSpec, WorkflowSet, WorkflowSpec
from repro_torch.configs import ARCH_IDS, get_config, port_config
from repro_torch.configs.wan_i2v import PROFILES, WanPipelineConfig
from repro_torch.core import RequestMonitor, critical_path, plan_dag, profiler
from repro_torch.models.aigc import (
    DAG_DEPS,
    WanI2VPipeline,
    build_dag_stage_fns,
    build_stage_fns,
)
from repro_torch.models.aigc.pipeline import measure_stage_times
from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set

APP_I2V = 1
STAGES = ("text_encode", "vae_encode", "diffusion", "vae_decode")
DEFAULT_RING_BYTES = 1 << 22   # WorkflowInstance's own default
MESSAGE_SLACK = 1 << 16        # header and payload metadata


def largest_message_bytes(cfg: WanPipelineConfig) -> int:
    """Bytes of the largest stage payload of one request, from the shapes:
    client -> asr {audio [1, 2 text_len] float32, image} (``a2v``; larger
    than the client's {tokens, image} of the other workflows), ->
    vae_encode {text_emb, image}, -> diffusion {text_emb, z_tokens}, ->
    vae_decode {latents}."""
    f32 = 4
    audio = 2 * cfg.text_len * f32
    image = cfg.image_size ** 2 * 3 * f32
    text_emb = cfg.text_len * cfg.text_d_model * f32
    z_tokens = cfg.video_tokens * cfg.patch ** 2 * cfg.vae_latent_ch * f32
    return MESSAGE_SLACK + max(audio + image, text_emb + image,
                               text_emb + z_tokens)


def ring_bytes_for(cfg: WanPipelineConfig, max_batch: int = 1) -> int:
    """Inbox ring size: room for 4 x max_batch of the largest message.  Two
    messages in flight plus the unusable tail an entry leaves when it wraps
    can take up to 3 messages' worth; 4 leaves margin."""
    return max(DEFAULT_RING_BYTES,
               4 * max(max_batch, 1) * largest_message_bytes(cfg))


def build_a2v_stage_fns(pipe: WanI2VPipeline) -> Dict[str, Any]:
    """Toy ASR and LLM front stages (deterministic numpy transforms standing
    in for Whisper and a prompt-rewriting LLM) feeding the real Wan DAG;
    their arithmetic is the JAX package's."""
    cfg = pipe.cfg
    dag = build_dag_stage_fns(pipe)

    def stage_asr(p):
        audio = np.asarray(p["audio"])  # [B, n] waveform
        toks = (np.abs(audio[:, :cfg.text_len]) * 997.0).astype(np.int64)
        return {"tokens": (toks % cfg.text_vocab).astype(np.int32),
                "image": p["image"], "seed": p["seed"]}

    def stage_llm(p):
        # image and seed ride along: text_encode wraps the chain's stage fn,
        # whose payload carries them
        toks = np.asarray(p["tokens"]).astype(np.int64)
        return {"tokens": ((toks * 31 + 7) % cfg.text_vocab).astype(np.int32),
                "image": p["image"], "seed": p["seed"]}

    return {"asr": stage_asr, "llm": stage_llm, **dag}


A2V_DEPS = {
    "asr": [],
    "llm": ["asr"],
    "text_encode": ["llm"],
    "image_encode": ["asr"],
    "diffusion": ["text_encode", "image_encode"],
    "vae_decode": ["diffusion"],
}


def workflow_spec(workflow: str, pipe: WanI2VPipeline,
                  times: Optional[Dict[str, float]] = None):
    """-> (WorkflowSpec, stage_times dict) for a named scenario.  Stage
    times are measured on the pipeline unless given."""
    times = times or measure_stage_times(pipe)
    if workflow == "chain":
        fns = build_stage_fns(pipe)
        spec = WorkflowSpec(APP_I2V, "wan-i2v", [
            StageSpec(s, fn=fns[s], exec_time_s=times[s]) for s in STAGES
        ])
        return spec, {s: times[s] for s in STAGES}
    if workflow == "dag":
        fns = build_dag_stage_fns(pipe)
        dag_times = {"text_encode": times["text_encode"],
                     "image_encode": times["vae_encode"],
                     "diffusion": times["diffusion"],
                     "vae_decode": times["vae_decode"]}
        spec = WorkflowSpec(APP_I2V, "wan-i2v-dag", [
            StageSpec(s, fn=fns[s], exec_time_s=dag_times[s],
                      deps=DAG_DEPS[s])
            for s in DAG_DEPS
        ])
        return spec, dag_times
    if workflow == "a2v":
        fns = build_a2v_stage_fns(pipe)
        # The toy asr and llm take microseconds; planned at that cost they
        # would pace the entrance and blow the per-path Theorem-1 counts up
        # to T_dit / T_asr instances, so they are budgeted as light encoder
        # stages, as the JAX package budgets them.
        a2v_times = {"asr": times["text_encode"], "llm": times["text_encode"],
                     "text_encode": times["text_encode"],
                     "image_encode": times["vae_encode"],
                     "diffusion": times["diffusion"],
                     "vae_decode": times["vae_decode"]}
        spec = WorkflowSpec(APP_I2V, "audio2video", [
            StageSpec(s, fn=fns[s], exec_time_s=a2v_times[s], deps=A2V_DEPS[s])
            for s in A2V_DEPS
        ])
        return spec, a2v_times
    raise ValueError(f"unknown workflow {workflow!r}")


def make_request(cfg: WanPipelineConfig, rng, i: int,
                 workflow: str = "chain") -> Dict[str, Any]:
    """One client request: prompt tokens, an image and a seed; an ``a2v``
    request carries a waveform ``audio [1, 2 text_len]`` in place of the
    tokens."""
    req = {
        "tokens": rng.integers(0, cfg.text_vocab,
                               (1, cfg.text_len)).astype(np.int32),
        "image": (rng.standard_normal(
            (1, cfg.image_size, cfg.image_size, 3)) * 0.1).astype(np.float32),
        "seed": i,
    }
    if workflow == "a2v":
        del req["tokens"]
        req["audio"] = rng.standard_normal((1, 2 * cfg.text_len)).astype(np.float32)
    return req


def build_set(spec: WorkflowSpec, *, counts, admit_rate: float,
              cfg: WanPipelineConfig, name: str = "ws0", max_batch: int = 1,
              max_wait_s: float = 0.02, elastic: bool = True,
              spares: int = 0) -> WorkflowSet:
    """A Workflow Set with ``counts[stage]`` instances per stage and
    ``spares`` idle-pool instances the control loop may pull onto a hot
    stage, each inbox ring sized for ``cfg``'s payloads
    (``ring_bytes_for``)."""
    ws = WorkflowSet(name, control_loop=elastic)
    ws.register_workflow(spec)
    # Without the elastic loop nothing reassigns instances mid-run, so the
    # stage fn can run inline on the scheduler thread; with it, keep the
    # worker thread so drain-and-handoff stays preemptive.
    kw = dict(max_batch=max_batch, max_wait_s=max_wait_s,
              pad_to_full=max_batch > 1, inline=not elastic,
              ring_bytes=ring_bytes_for(cfg, max_batch))
    for stage, n in counts.items():
        for i in range(n):
            ws.add_instance(f"{stage}_{i}", stage=stage, **kw)
    for i in range(spares):
        ws.add_instance(f"spare_{i}", **kw)
    # nm_managed: the live control loop keeps (T_X, K) tracking the actual
    # entrance-stage instance count as it rebalances (§5)
    mon = RequestMonitor(t_entrance_s=1.0 / max(admit_rate, 1e-9), k_entrance=1,
                         window_s=2.0, nm_managed=elastic)
    ws.add_proxy("p0", monitor=mon)
    return ws


def serve(ws: WorkflowSet, reqs: List[Dict[str, Any]], *, app: int = APP_I2V,
          batched: bool = False,
          timeout_s: float = 600.0) -> Tuple[List[Any], int, float]:
    """Submit ``reqs`` of workflow ``app`` through the set's proxy and wait
    for every result; ``batched`` submits them in one burst.
    -> (results in request order, results lost, wall seconds).  A request
    that times out is counted as lost (§9: the data plane may drop and never
    retransmits; a production client resubmits)."""
    proxy = ws.proxies[0]
    t0 = time.perf_counter()
    with ws:
        if batched:
            uids = proxy.submit_many(app, reqs)  # one doorbell-batched burst
        else:
            uids = []
            for r in reqs:
                while True:
                    try:
                        uids.append(proxy.submit(app, r))
                        break
                    except Rejected:
                        time.sleep(0.05)  # fast-rejected: retry (client behavior)
        outs, lost = [], len(reqs) - len(uids)
        for u in uids:
            try:
                outs.append(proxy.wait_result(u, timeout_s=timeout_s))
            except TimeoutError:
                lost += 1
    return outs, lost, time.perf_counter() - t0


def llm_config(arch: str, profile: str, cache_dtype: str = ""):
    """The ``llm`` workflow's model: full width in bfloat16 at ``port``, at
    the depth one card holds (``configs.port_config``: deepseek-67b's
    ``PORT_LAYERS``, the rest whole), the reduced float32 config at
    ``small``.  An attention-free model (rwkv6) has no KV cache, so a cache
    type is refused for it; the config refuses an int8 cache for gemma3's
    rings and for the audio and hybrid families (ValueError)."""
    cfg = port_config(arch) if profile == "port" else get_config(arch)
    if cache_dtype and cfg.attention_free:
        raise ValueError(
            f"--cache-dtype {cache_dtype}: {arch} is attention-free; its decode "
            f"state (token shifts and the WKV state) has no KV cache to store "
            f"in {cache_dtype}")
    if profile == "small":
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    return dataclasses.replace(cfg, cache_dtype=cache_dtype)


def llm_requests(cfg, rng, prompt_lens, steps: int, temperatures):
    """One request per prompt length: random prompt tokens, ``steps`` new
    tokens, temperatures in turn, seed = request index."""
    return [{"prompt": rng.integers(0, cfg.vocab_size, (1, p)).astype(np.int32),
             "steps": steps, "temperature": float(temperatures[i % len(temperatures)]),
             "seed": i} for i, p in enumerate(prompt_lens)]


def check_served(engine, reqs, outs) -> None:
    """Hold every served token stream against the engine's solo ``generate``
    of that request; raises AssertionError naming the first that differs.
    The RNG contract makes a request's tokens independent of the slot batch
    that served it."""
    for i, (o, r) in enumerate(zip(outs, reqs)):
        solo = engine.generate(r["prompt"], steps=r["steps"],
                               temperature=r["temperature"], seed=r["seed"]).tokens
        if not np.array_equal(o, solo):
            raise AssertionError(f"request {i}: served tokens differ from solo "
                                 f"generate")


def start_profile(args) -> None:
    """--profile-latency: record per-request latency spans from here on."""
    if args.profile_latency:
        profiler().reset()
        profiler().enable()


def print_profile(args) -> None:
    """--profile-latency: the per-stage phase breakdown (p50 ms)."""
    if args.profile_latency:
        prof = profiler()
        prof.disable()
        print("per-stage latency (p50 ms by phase):")
        for stage, phases in prof.timeline():
            inner = " ".join(f"{ph}={v:.2f}" for ph, v in phases.items())
            print(f"  {stage:>14}: {inner}")


def run_llm(args) -> int:
    """--workflow llm: the two-stage llm_disagg Workflow Set end to end."""
    cfg = llm_config(args.llm_arch, args.profile, args.cache_dtype)
    max_len = args.max_len or (64 if args.profile == "small" else 1024)
    engine = ServingEngine(cfg, max_len=max_len, seed=args.seed,
                           device=args.device)
    ws, decoder = build_llm_disagg_set(
        engine, name="llm", max_slots=args.llm_slots,
        segment_len=args.llm_segment, prefill_batch=args.max_batch)
    rng = np.random.default_rng(args.seed)
    reqs = llm_requests(cfg, rng, [max_len // 16] * args.requests,
                        args.llm_steps, [0.7])
    start_profile(args)
    outs, lost, wall = serve(ws, reqs, app=APP_LLM_DISAGG, batched=True)
    stats = ws.transport_stats()
    n_tok = sum(r["steps"] for r in reqs[:len(outs)])
    state = ("recurrent state" if cfg.attention_free
             else f"cache {cfg.resolved_cache_dtype}")
    print(f"{cfg.name} ({cfg.dtype}, {state}) on "
          f"{engine.device}: {len(outs)}/{len(reqs)} requests x "
          f"{args.llm_steps} tokens in {wall:.2f}s ({n_tok / wall:.1f} tokens/s), "
          f"lost={lost}, dropped={stats.dropped}")
    print(f"decode slots: admitted={decoder.stats['admitted']} "
          f"segments={decoder.stats['segments']} "
          f"max_resident={decoder.stats['max_resident']}/{args.llm_slots}")
    print(f"kv shipping: {stats.kv_pages} KVPages messages, "
          f"{stats.kv_bytes / 1e6:.1f} MB of cache over the fabric")
    print_profile(args)
    if lost or stats.dropped:
        return 1
    check_served(engine, reqs, outs)
    print("served tokens equal the engine's solo generate")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--profile", default="port", choices=sorted(PROFILES))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workflow", default="chain",
                    choices=["chain", "dag", "a2v", "llm"],
                    help="stage topology: linear chain, the branch-parallel "
                         "Wan DAG, the nested audio-to-video DAG, or "
                         "disaggregated prefill/decode LLM serving")
    ap.add_argument("--max-batch", type=int, default=1,
                    help="stage-level microbatch size (1 = per-request)")
    ap.add_argument("--batch-wait-ms", type=float, default=20.0,
                    help="partial-batch flush deadline")
    ap.add_argument("--no-elastic", action="store_true",
                    help="disable the live NodeManager control loop (§8.2)")
    ap.add_argument("--spare-instances", type=int, default=0,
                    help="extra idle-pool instances the control loop may "
                         "pull onto a hot stage")
    ap.add_argument("--profile-latency", action="store_true",
                    help="record per-request latency spans and print the "
                         "per-stage phase breakdown (docs/perf.md)")
    ap.add_argument("--llm-arch", default="qwen3-1.7b", choices=ARCH_IDS,
                    help="--workflow llm: model config")
    ap.add_argument("--llm-steps", type=int, default=16,
                    help="--workflow llm: decode tokens per request")
    ap.add_argument("--llm-slots", type=int, default=8,
                    help="--workflow llm: continuous-batching decode slots")
    ap.add_argument("--llm-segment", type=int, default=4,
                    help="--workflow llm: tokens per decode segment "
                         "(join/leave granularity)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="--workflow llm: decode cache length (default 1024 "
                         "at port, 64 at small; gemma3-27b serves at 2048)")
    ap.add_argument("--cache-dtype", default="", choices=["", "int8"],
                    help="--workflow llm: KV cache type ('' = the model's; "
                         "refused for the attention-free rwkv6, for "
                         "gemma3's ring caches, whisper and zamba2)")
    args = ap.parse_args()

    if args.workflow == "llm":
        try:
            llm_config(args.llm_arch, args.profile, args.cache_dtype)
        except ValueError as e:
            ap.error(str(e))
        return run_llm(args)

    start_profile(args)
    pipe = WanI2VPipeline(cfg=PROFILES[args.profile], seed=args.seed,
                          device=args.device)
    cfg = pipe.cfg
    spec, times = workflow_spec(args.workflow, pipe)
    print("stage times (s):", {k: round(v, 4) for k, v in times.items()})

    # Theorem 1 per path: instance counts that rate-match the entrance
    deps = spec.resolved_deps()
    counts = plan_dag(times, deps, k_entrance=1)
    print("Theorem-1 plan:", counts)
    cp_latency, cp = critical_path(times, deps)
    print(f"critical path: {' -> '.join(cp)} = {cp_latency:.4f}s "
          f"(serialized sum {sum(times.values()):.4f}s)")

    entrance_t = max(times[s] for s in spec.entrance_stages())
    ws = build_set(spec, counts=counts, admit_rate=1.0 / entrance_t, cfg=cfg,
                   max_batch=args.max_batch, max_wait_s=args.batch_wait_ms / 1e3,
                   elastic=not args.no_elastic, spares=args.spare_instances)
    rng = np.random.default_rng(args.seed)
    reqs = [make_request(cfg, rng, i, args.workflow) for i in range(args.requests)]
    videos, lost, wall = serve(ws, reqs, batched=args.max_batch > 1)

    for v in videos:
        assert np.isfinite(v).all()
    if videos:
        print(f"{len(videos)} videos of shape {videos[0].shape} in {wall:.2f}s "
              f"({len(videos)/wall:.2f} req/s) on {pipe.device}")
    if lost:
        print(f"{lost}/{len(reqs)} results lost (dropped or timed out)")
    print("per-instance processed:",
          {n: i.stats.processed for n, i in ws.instances.items()})
    js = ws.joins.stats
    if js.offered:
        print(f"joins: {js.completed} assembled from {js.offered} partials, "
              f"{js.aborted_joins} aborted, pending={ws.joins.pending_joins()}")
    if ws.control is not None:
        print(f"control loop: {ws.control.steps} ticks, "
              f"moves={ws.control.moves}, evicted={ws.control.evicted}, "
              f"capacity_pushes={ws.control.capacity_pushes}")
    stats = ws.transport_stats()
    print(f"transport: {stats.sent} sent, {stats.dropped} dropped, "
          f"{stats.bytes_sent/1e6:.1f} MB")
    print_profile(args)
    return 0 if not lost and stats.dropped == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
