"""chip_smoke.py's phases of the batched scheduler (16-19), the fleet
(20-22), LM serving (8 and 23-26) and the LM FL tasks, FL -> serve,
Whisper and InternVL2 (27-34), rehearsed on CPU tensors at a small fleet
and the smoke configs, so that the script's own checks do not rot
between card runs."""
import os
import sys

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_batched_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's phases 16-19 on CPU tensors at a small fleet: the
    batched-against-heap and wave card-against-CPU phases pass (CPU
    against CPU here); the wave runs of phases 17 and 18 run, time their
    layers, hold the inputs their channel calls kept against the plain
    version (the plain version twice here), and then fail their launch
    check, as they must off the card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True, wave_fleet=1000,
                             wave_walls=(3.0, 1.5))
    for phase in (smoke.batched_vs_heap, smoke.wave_dispatch,
                  smoke.wave_steps, smoke.wave_card_vs_cpu):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == ["wave_dispatch", "wave_steps"]
    out = capsys.readouterr()
    assert out.err.count(
        "AssertionError: kernel B did not run inside sim.run") == 2
    checked = [ln for ln in out.out.splitlines()
               if "on the run's own inputs" in ln]
    assert len(checked) == 2 and "zero_step:" in checked[0]
    assert not any(k.startswith("wave") for k in smoke.kernels["topk_quant"])


def test_chip_smoke_fleet_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's phases 20-22 on CPU tensors at a small fleet: the
    fleet runs both jobs to 5 rounds and holds its largest channel input
    against the plain version (the plain version twice here), then fails
    its launch check, as it must off the card; the resume phase (engine
    and fleet, through files) and the fleet's card-against-CPU phase (CPU
    against CPU here) pass."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True)
    for phase in (smoke.fleet_path, smoke.checkpoint_resume,
                  smoke.fleet_card_vs_cpu):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == ["fleet_path"]
    out = capsys.readouterr()
    assert out.err.count("AssertionError: kernel B did not run inside "
                         "MultiTaskEngine.run") == 1
    assert "largest channel input" in out.out
    assert out.out.count("bit-identical),") == 2    # engine and fleet resume
    assert "load_sim_params(task=j, device='cpu') equals" in out.out
    assert not any(k.startswith("fleet") for k in smoke.kernels["topk_quant"])
    assert smoke.kernels["topk_quant"]["resume_engine_max_weight_diff"] == 0


def test_chip_smoke_lm_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's serving phases on CPU tensors at the smoke configs:
    Mamba2 through the shared serving window (8), kernel C at the Jamba
    config's prefill shape (23), Qwen3 through the batcher and a prompt
    past the flash threshold against the plain branch (24), the Jamba
    group through generate (25; no kernel launch off the card), and the
    seven decoder-only families card against CPU (26; CPU against CPU
    here).  All pass: each launch check expects 0 launches off the card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True)
    for phase in (smoke.serve_ssm, smoke.kernel_c_jamba, smoke.serve_qwen,
                  smoke.serve_jamba, smoke.lm_card_vs_cpu):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == []
    out = capsys.readouterr().out
    assert out.count("batcher tokens equal solo generate on 8 of 8") == 2
    assert "prefill of 1 x 2304 tokens: flash branch" in out
    assert "batch row tokens equal solo generate on 4 of 4" in out
    assert "N=16), b and c in f32 and bf16" in out
    assert out.count("greedy tokens of 2 x 8 equal") == 7
    assert smoke.lm["jamba"]["launches"]["ssd_scan"] == 0
    assert smoke.lm["qwen"]["flash_vs_plain"] <= chip_smoke.FLASH_TOL


def test_chip_smoke_lm_task_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's phases 27-34 on CPU tensors at a small fleet and
    the smoke configs: kernel C's gradient against autograd through its
    plain version (27; the plain version twice here, and the gradient
    with C's outputs detached visibly off), the three LM tasks serial and
    cohort with A and B on transformer_lm's nested tree (28), the
    four-family fleet with both assigners (29, 200 devices to a virtual
    budget of 2 s, so that every job's rounds do not depend on the
    machine's pace), the LM tasks
    card against CPU (30; CPU against CPU), FL -> serve from engine and
    fleet blobs (31), Whisper and InternVL2 (32-34).  All pass: each
    launch check expects 0 launches off the card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True, fleet4=(200, 8, None, 0.25, 2.0))
    for phase in (smoke.kernel_c_grad, smoke.lm_tasks,
                  smoke.four_family_fleet, smoke.lm_card_vs_cpu_tasks,
                  smoke.fl_to_serve, smoke.serve_whisper, smoke.serve_vlm,
                  smoke.encdec_vlm_card_vs_cpu):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == []
    out = capsys.readouterr().out
    assert smoke.kernels["ssd_scan"]["grad_detached_rel_err"] > 0.01
    assert "transformer_lm's trained tree: kernel A's stream" in out
    assert out.count("time, round and byte columns equal") == 6
    assert out.count("batcher tokens equal solo generate on 8 of 8") == 2
    assert "--job 1, 2 and 3 load their own job's weights" in out
    fleet = smoke.lm["fleet4"]
    assert fleet["weighted"]["budget_s"] == fleet["adaptive"]["budget_s"]
    assert all(r["rounds"] >= 1 for a in ("weighted", "adaptive")
               for r in fleet[a]["jobs"])
    assert smoke.lm["whisper"]["prefill_vs_forward"] <= chip_smoke.LOGIT_TOL
    assert smoke.lm["internvl2"]["prefill_vs_forward"] <= \
        chip_smoke.LOGIT_TOL
    assert "whisper-tiny/smoke: forward and prefill logits" in out


def test_chip_smoke_trainer_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's phases 35-39 on CPU tensors at the smoke configs:
    kernel B's channel form at the trainer's rows (the plain version twice
    here), the federated round of SmolLM and Mamba2 through
    ``launch/train.py`` (the first round's combine, the three schedules,
    the group gradients through kernel C's Function against its plain
    version), Qwen3's AdamW steps with their checkpoint, and the trainer
    and the legacy simulator card against CPU (CPU against CPU here).  All
    pass: each launch check expects 0 launches off the card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True)
    for phase in (smoke.channel_trainer_rows, smoke.fed_smollm,
                  smoke.fed_mamba, smoke.train_qwen,
                  smoke.trainer_card_vs_cpu):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == []
    out = capsys.readouterr().out
    assert out.count("equal to the plain version") == 4
    assert "equals the same deltas through threshold_channel_plain" in out
    assert smoke.train["fed_smollm"]["rounds"] == 5
    assert smoke.train["fed_mamba"]["grad_max_abs_err"] <= chip_smoke.SSD_TOL
    first, last = smoke.train["qwen_plain"]["first_batch_loss"]
    assert last < first
    assert "loaded back equal" in out
    assert out.count("time, round and byte columns equal") == 2


def test_chip_smoke_mesh_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's phase 11 (kernel B's channel form, with its wire at
    p_q <= 8) and phases 40-43 (the mesh slice in a world of 1, gloo
    here) on CPU tensors at a small fleet and the smoke configs: the
    sharded server equal to the single one bit for bit, the flat body
    within 1 ulp, the (1, 1) mesh round equal to the no-mesh round with
    the int4 wire halving the level bytes, the EP MoE within 1e-4 of the
    dense route, the sequence-sharded decode within 1e-4 of plain decode
    with equal tokens.  All pass: each launch check expects 0 launches
    off the card."""
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True, channel_cs=(1, 8))
    for phase in (smoke.channel_b, smoke.sharded_server, smoke.fed_mesh,
                  smoke.ep_jamba, smoke.seqshard_qwen):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == []
    assert not dist.is_initialized()         # every phase ends its world
    out = capsys.readouterr().out
    assert "also with the wire" in out
    assert out.count("world: 1 rank under gloo") == 4
    assert smoke.mesh["server"]["ulps"] == {2: 0, 4: 0}
    assert smoke.mesh["fed"][8]["exact"] and smoke.mesh["fed"][4]["exact"]
    assert smoke.mesh["ep"]["err"] <= chip_smoke.EP_TOL
    assert smoke.mesh["seqshard"]["err"] <= chip_smoke.SEQSHARD_TOL


def test_chip_smoke_dryrun_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's phases 44-48 on CPU tensors at the smoke configs:
    the recomputing federated round within the gather_q rule of the plain
    one, the dry run in a process a record (Qwen3's and Mamba2's
    decode_32k, arguments the rules' block), the dry run's predictions
    held to a real run (here the CPU run, whose arguments must still be
    predicted exactly), two of the example twins run in this process with
    their lines captured, and a tensor-parallel rank of a fake world of 4
    (its blocks' bytes the prediction and the rules' block).  All pass:
    each launch check expects 0 launches off the card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True,
                             twins=("torch_quickstart.py",
                                    "torch_compression_kernel_demo.py"))
    for phase in (smoke.fed_remat, smoke.dryrun_host, smoke.dryrun_vs_card,
                  smoke.example_twins, smoke.tp_rank):
        smoke.phase(phase.__name__, phase)
    assert smoke.failures == []
    out = capsys.readouterr().out
    rr = smoke.dryrun["remat_round"]
    assert rr["loss_diff"] <= 1e-4
    recs = smoke.dryrun["records"]
    assert sorted((r["arch"], r["shape"]) for r in recs) == [
        ("mamba2_370m", "decode_32k"), ("qwen3_1_7b", "decode_32k")]
    assert all("error" not in r for r in recs)
    for key in ("prefill", "round"):
        tp = smoke.tp[key]
        assert tp["argument_bytes"] == tp["rules_block"] > 0
        assert tp["collectives"] > 0
    for key in ("decode", "train"):
        assert smoke.dryrun["vs_card"][key]["argument_bytes"] > 0
    assert "torch_quickstart.py --budget 2 --samples 200: 4 lines" in out
    assert "torch_compression_kernel_demo.py : 6 lines" in out


def test_chip_smoke_ssm_tp_phase_rehearses_on_cpu(capsys):
    """chip_smoke.py's phase 49 on CPU tensors at the smoke configs: the
    head-parallel Mamba2 as rank 0 of a fake world of 4 (2 of 8 heads a
    rank): the prefill's, decode's and round's arguments equal to the
    prediction and the rules' block, the peaks the prediction, the decode
    state the rank's block, greedy steps from the prefill's state, one
    Jamba mixer, and kernel C's cells at the rank's shapes and one head
    a rank (plain against plain here).  Each launch check expects 0
    launches off the card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    smoke = chip_smoke.Smoke("cpu", n_devices=10, n_train=1000, n_test=500,
                             ssm_smoke=True)
    smoke.phase("ssm_tp_rank", smoke.ssm_tp_rank)
    assert smoke.failures == []
    out = smoke.ssm_tp
    for key in ("prefill", "decode", "round"):
        assert out[key]["argument_bytes"] == out[key]["rules_block"] > 0
        assert out[key]["collectives"] > 0
        assert out[key]["ssd_scan"] == 0
    assert out["decode"]["argument_bytes"] > out["prefill"]["argument_bytes"]
    assert sorted(out["kernel_c"]) == ["jamba", "mamba2", "one_head"]
    assert out["kernel_c"]["one_head"]["heads"] == 1
    assert "greedy decode steps on the rank's state block" in \
        capsys.readouterr().out
