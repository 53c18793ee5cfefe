"""The port's task heads and task-aware eval (`fedml_tpu_torch.core.
algorithm`: nwp, regression, multilabel, segmentation with its whole-set
mIoU) and one Simulator round of each task against the JAX package's, on
the CPU; the centralized trainer's pooled per-token and per-pixel epoch
against plain autograd SGD steps.

Heads get the same numpy inputs on both sides: loss and its gradient
within 1e-6 of their largest magnitude (f32, the same sums in another
order), the counts exact. The mIoU is held to JAX's `miou_from_logits`
and to a count by hand, both within 1e-6. Rounds get the JAX Simulator's
initial parameters and batch schedules and agree within 1e-3 of the
largest parameter update (the repo's rule for rounds); train and test
losses within 1e-5 relative. No test here may reach vmap's per-example
fallback: its warning is an error.
"""
import jax
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.core import algorithm as jalg
from fedml_tpu.data import loader as jax_loader
from fedml_tpu.data.fed_dataset import pack_client_shards as jax_pack
from fedml_tpu.simulation.simulator import Simulator as JaxSimulator

import fedml_tpu_torch
from fedml_tpu_torch.centralized import CentralizedTrainer
from fedml_tpu_torch.core import algorithm as alg
from fedml_tpu_torch.data import loader
from fedml_tpu_torch.data.fed_dataset import pack_client_shards
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.simulation.simulator import Simulator

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop because we have not yet implemented "
    "the batching rule")

HEAD_TOL = 1e-6    # of the largest |value|: the same f32 sums reordered
ROUND_TOL = 1e-3   # max |param diff| over the largest parameter update


def _head_inputs(task, rs):
    """(model output, y, mask) for `task`, two padded rows (mask 0), with
    pad tokens (nwp) and ignore pixels (segmentation) in real rows."""
    B = 6
    mask = np.ones(B, np.float32)
    mask[-2:] = 0.0
    if task == "nwp":
        out = rs.randn(B, 7, 11).astype(np.float32)
        y = rs.randint(0, 11, (B, 7))
        y[0, :3] = 0
        y[-2:] = 0
    elif task in ("regression", "regression_col"):
        shape = (B, 1) if task == "regression_col" else (B,)
        out = rs.randn(*shape).astype(np.float32)
        return out, rs.randn(B).astype(np.float32), mask
    elif task == "multilabel":
        out = rs.randn(B, 9).astype(np.float32)
        y = (rs.rand(B, 9) < 0.3).astype(np.int64)
    else:
        out = rs.randn(B, 5, 4, 6).astype(np.float32)
        y = rs.randint(0, 6, (B, 5, 4))
        y[1, 0] = 255
        y[2, :, 1] = 255
    return out, y.astype(np.int64), mask


HEADS = {"nwp": "nwp", "regression": "regression",
         "regression_col": "regression", "multilabel": "multilabel",
         "segmentation": "segmentation", "classification": "classification"}


@pytest.mark.parametrize("case", list(HEADS))
def test_heads_match_jax(case):
    """Each objective against its JAX original: (loss, correct, count)
    and d loss / d output. Pad targets (nwp), the ignore label 255
    (segmentation) and padded rows count nowhere."""
    rs = np.random.RandomState(7)
    out, y, mask = _head_inputs(case, rs)
    if case == "classification":
        out, y = rs.randn(6, 5).astype(np.float32), rs.randint(0, 5, 6)
    fj = jalg.make_objective(HEADS[case])
    ft = alg.make_objective(HEADS[case])
    want = [np.asarray(v) for v in fj(out, y, mask)]
    gj = np.asarray(jax.grad(lambda o: fj(o, y, mask)[0])(out))
    o = torch.from_numpy(out).requires_grad_()
    got = ft(o, torch.from_numpy(y), torch.from_numpy(mask))
    got[0].backward()
    np.testing.assert_allclose(float(got[0].detach()), want[0],
                               rtol=HEAD_TOL)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-6)
    assert float(got[2]) == float(want[2])
    np.testing.assert_allclose(o.grad.numpy(), gj, rtol=0,
                               atol=HEAD_TOL * np.abs(gj).max())
    if case == "nwp":      # the pads and padded rows are out of the count
        assert float(got[2]) == float(((y != 0) * mask[:, None]).sum())
    if case == "segmentation":
        assert float(got[2]) == float(((y != 255) * mask[:, None, None])
                                      .sum())


def _hand_miou(pred, y, mask, n):
    """The mIoU by counting pixels in Python."""
    inter = np.zeros(n)
    union = np.zeros(n)
    for b in range(y.shape[0]):
        if mask[b] == 0:
            continue
        for t, p in zip(y[b].ravel(), pred[b].ravel()):
            if t == 255:
                continue
            if t == p:
                inter[t] += 1
                union[t] += 1
            else:
                union[t] += 1
                union[p] += 1
    present = union > 0
    return (inter[present] / union[present]).mean()


def test_miou_matches_jax_and_hand_count():
    rs = np.random.RandomState(8)
    out, y, mask = _head_inputs("segmentation", rs)
    y[y == 5] = 4              # class 5 absent from the targets
    want, want_iou = (np.asarray(v) for v in jalg.miou_from_logits(
        out, y, 6, mask))
    got, got_iou = alg.miou_from_logits(torch.from_numpy(out),
                                        torch.from_numpy(y), 6,
                                        torch.from_numpy(mask))
    hand = _hand_miou(out.argmax(-1), y, mask, 6)
    assert float(got) == pytest.approx(float(want), abs=HEAD_TOL)
    assert float(got) == pytest.approx(hand, abs=HEAD_TOL)
    np.testing.assert_allclose(got_iou.numpy(), want_iou, atol=HEAD_TOL)
    # without a mask every row counts
    want = float(jalg.miou_from_logits(out, y, 6)[0])
    got = float(alg.miou_from_logits(torch.from_numpy(out),
                                     torch.from_numpy(y), 6)[0])
    assert got == pytest.approx(want, abs=HEAD_TOL)


def test_seg_eval_is_whole_set_confusion():
    """The segmentation eval sums the confusion matrix over every batch
    (JAX's seg_eval_fn), which differs from a mean of per-batch mIoUs."""
    rs = np.random.RandomState(9)
    x = rs.randn(3, 4, 5, 4, 6).astype(np.float32)     # [nb, B, H, W, C]
    y = rs.randint(0, 6, (3, 4, 5, 4))
    y[0] = np.where(y[0] > 2, 255, y[0])
    mask = np.ones((3, 4), np.float32)
    mask[2, 3] = 0.0
    ident_j = lambda variables, xb: xb                  # logits = input
    want = jax.device_get(jalg.make_eval_fn(ident_j, "segmentation", 6)(
        {}, x, y, mask))
    got = alg.make_eval_fn(lambda p, xb: xb, "segmentation", 6)(
        {}, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    for k in ("loss", "acc", "miou", "per_class_iou", "n"):
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    per_batch = np.mean([float(alg.miou_from_logits(
        torch.from_numpy(x[i]), torch.from_numpy(y[i]), 6,
        torch.from_numpy(mask[i]))[0]) for i in range(3)])
    assert abs(per_batch - float(got["miou"])) > 1e-3
    with pytest.raises(ValueError, match="num_classes"):
        alg.make_eval_fn(lambda p, xb: xb, "segmentation")


def test_every_task_is_accepted():
    assert sorted(alg.OBJECTIVES) == sorted(jalg.OBJECTIVES)
    for t in ("classification", "nwp", "regression", "multilabel",
              "segmentation", None, "NWP"):
        assert alg.make_objective(t) is not None
    with pytest.raises(ValueError) as e_t:
        alg.make_objective("ranking")
    with pytest.raises(ValueError) as e_j:
        jalg.make_objective("ranking")
    assert str(e_t.value) == str(e_j.value)


# --------------------------------------------------- one round of each task
def _regression_data(n_clients=4, seed=11):
    """A regression set with float targets (y = x . w + noise): both
    packages' pack_client_shards write the training targets as int64, so
    they train truncated (ROADMAP C.8); the test targets keep their
    float dtype."""
    rs = np.random.RandomState(seed)
    x = rs.randn(60, 6).astype(np.float32)
    w = rs.randn(6).astype(np.float32)
    y = (x @ w + 0.1 * rs.randn(60)).astype(np.float32)
    xt = rs.randn(20, 6).astype(np.float32)
    yt = (xt @ w).astype(np.float32)
    parts = np.array_split(rs.permutation(60), n_clients)
    return [pack(x, y, parts, xt, yt, 1, pad_multiple=8)
            for pack in (jax_pack, pack_client_shards)]


# task -> (dataset, model, model_args.extra, rows kept a client, crop)
TASKS = {
    "nwp": ("shakespeare", "rnn", {"hidden": 16}, 16, 12),
    "segmentation": ("pascal_voc", "unet",
                     {"features": [8], "bottleneck": 16}, 8, 16),
    "multilabel": ("stackoverflow_lr", "lr", {}, 16, None),
    "regression": (None, "lr", {}, None, None),
}


def _task_cfg(task, tmp_path, group):
    dataset, model, mx, _rows, _crop = TASKS[task]
    return {"data_args": {"dataset": dataset or "synthetic",
                          "data_cache_dir": str(tmp_path),
                          "extra": {"synthetic_samples_per_client": 8}},
            "model_args": {"model": model, "extra": mx},
            "train_args": {"client_num_in_total": 4,
                           "client_num_per_round": 3, "comm_round": 1,
                           "batch_size": 8, "learning_rate": 0.1,
                           "extra": {"task": task,
                                     "clients_per_device_parallel": group}},
            "validation_args": {"frequency_of_the_test": 1}}


def _crop(ds, rows, crop):
    """The first `rows` rows a client; tokens cut to `crop` positions, or
    images and masks to crop x crop."""
    ds.x_train, ds.y_train = ds.x_train[:, :rows], ds.y_train[:, :rows]
    ds.mask_train = ds.mask_train[:, :rows]
    ds.counts = np.minimum(ds.counts, rows)
    ds.x_test, ds.y_test = ds.x_test[:24], ds.y_test[:24]
    if crop is not None:
        cut = (slice(crop),) * (ds.y_train.ndim - 2)   # T, or H and W
        ds.x_train = ds.x_train[(slice(None),) * 2 + cut]
        ds.y_train = ds.y_train[(slice(None),) * 2 + cut]
        ds.x_test = ds.x_test[(slice(None),) + cut]
        ds.y_test = ds.y_test[(slice(None),) + cut]
    return ds


@pytest.mark.parametrize("task,group", [("nwp", 1), ("nwp", 3),
                                        ("segmentation", 3),
                                        ("multilabel", 1),
                                        ("regression", 1)])
def test_round_of_each_task_matches_jax(task, group, tmp_path):
    """One round (3 of 4 clients) and one eval of each task through both
    Simulators, the port handed the JAX initial parameters and schedule:
    nwp with CharRNN (one client at a time and a vmapped group of 3),
    segmentation with UNetLite (its eval row carries test_miou),
    multilabel and regression with lr."""
    d = _task_cfg(task, tmp_path, group)
    cj, ct = fedml_tpu.init(config=d), fedml_tpu_torch.init(config=d,
                                                            device="cpu")
    if task == "regression":
        ds_j, ds_t = _regression_data()
    else:
        _ds, _m, _mx, rows, crop = TASKS[task]
        ds_j = _crop(jax_loader.load(cj), rows, crop)
        ds_t = _crop(loader.load(ct), rows, crop)
    sim_j = JaxSimulator(cj, ds_j)
    p0 = jax.tree.map(np.asarray, sim_j.params)
    hist_j = sim_j.run()
    seed = ct.common_args.random_seed

    def schedule(r):
        rng = jax.random.fold_in(jax.random.key(seed), r)
        return torch.from_numpy(np.stack([np.asarray(
            jalg.make_batch_indices(jax.random.fold_in(rng, int(i)),
                                    ds_t.x_train.shape[1], 8, 1))
            for i in sim_t.sample_clients(r)]).astype(np.int64))

    sim_t = Simulator(ct, ds_t, params=hub.params_from_flax(p0,
                                                            device="cpu"))
    hist_t = sim_t.run(batch_schedule=schedule)
    (hj,), (ht,) = hist_j, hist_t
    for k in ("train_loss", "test_loss", "test_acc") + (
            ("test_miou",) if task == "segmentation" else ()):
        assert ht[k] == pytest.approx(hj[k], rel=1e-5, abs=1e-6), k
    init = hub.params_from_flax(p0, device="cpu")
    final = hub.params_from_flax(jax.tree.map(
        np.asarray, sim_j.server_state.params), device="cpu")
    update = max(float((final[k] - init[k]).abs().max()) for k in final)
    assert update > 0
    for k, v in final.items():
        err = float((sim_t.server_state.params[k] - v).abs().max())
        assert err <= ROUND_TOL * update, (k, err, update)


def test_label_dtypes_kept_as_jax_keeps_them(tmp_path):
    """ROADMAP C.8, on both packages: pack_client_shards writes float
    regression targets as int64 (truncated toward zero), so a regression
    trains on truncated targets; the test labels keep their float dtype,
    and the eval's MSE is against the float targets."""
    ds_j, ds_t = _regression_data()
    for ds in (ds_j, ds_t):
        assert ds.y_train.dtype == np.int64 and ds.y_test.dtype == np.float32
    np.testing.assert_array_equal(ds_t.y_train, ds_j.y_train)
    d = _task_cfg("regression", tmp_path, 1)
    sim_j = JaxSimulator(fedml_tpu.init(config=d), ds_j)
    p0 = jax.tree.map(np.asarray, sim_j.params)
    sim_t = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), ds_t,
                      params=hub.params_from_flax(p0, device="cpu"))
    assert sim_t._test[1].dtype == torch.float32
    pred = ds_t.x_test @ p0["Dense_0"]["kernel"][:, 0] + p0["Dense_0"]["bias"]
    mse = float(np.mean((pred - ds_t.y_test) ** 2))
    for m in (sim_t.evaluate(), sim_j.evaluate()):
        assert m["test_loss"] == pytest.approx(mse, rel=1e-5)
    trunc = float(np.mean((pred - ds_t.y_test.astype(np.int64)) ** 2))
    assert abs(trunc - mse) > 1e-3 * mse


def _pool_by_loop(ds):
    """The pooled shard by a loop over clients: each client's rows with
    mask > 0, in order, their trailing axes kept."""
    keep = [ds.mask_train[i] > 0 for i in range(ds.x_train.shape[0])]
    return (np.concatenate([ds.x_train[i][k] for i, k in enumerate(keep)]),
            np.concatenate([ds.y_train[i][k] for i, k in enumerate(keep)]))


def _centralized_case(task, tmp_path):
    """(config, a cropped dataset with two padding rows in the middle of
    the shards) for the centralized trainer."""
    d = _task_cfg(task, tmp_path, 1)
    d["common_args"] = {"training_type": "centralized"}
    ct = fedml_tpu_torch.init(config=d, device="cpu")
    _ds, _m, _mx, rows, crop = TASKS[task]
    ds = _crop(loader.load(ct), rows, crop)
    ds.mask_train = ds.mask_train.copy()
    ds.mask_train[0, 3] = ds.mask_train[2, 0] = 0.0
    return ct, ds


@pytest.mark.parametrize("task", ["segmentation", "nwp", "classification"])
def test_pool_clients_keeps_real_rows_in_order(task, tmp_path):
    """pool_clients bitwise against a loop over the clients, per-token
    and per-pixel targets included; for [N, S] labels also bitwise
    against the JAX package's pool_clients (which cannot index the
    others by the sample mask)."""
    from fedml_tpu.centralized import pool_clients as jax_pool
    from fedml_tpu_torch.centralized import pool_clients
    if task == "classification":
        rs = np.random.RandomState(5)
        parts = np.array_split(rs.permutation(40), 4)
        ds = pack_client_shards(rs.randn(40, 3).astype(np.float32),
                                rs.randint(0, 4, 40), parts,
                                rs.randn(8, 3).astype(np.float32),
                                rs.randint(0, 4, 8), 4, pad_multiple=8)
        ds.mask_train[1, 2] = 0.0
    else:
        _ct, ds = _centralized_case(task, tmp_path)
    got = pool_clients(ds)
    x, y = _pool_by_loop(ds)
    n = int((ds.mask_train > 0).sum())
    assert x.shape[0] == n < ds.mask_train.size
    for k, want in (("x", x), ("y", y)):
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    np.testing.assert_array_equal(got["mask"], np.ones(n, np.float32))
    if task == "classification":
        for k, v in jax_pool(ds).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("task", ["segmentation", "nwp"])
def test_centralized_segmentation_and_nwp(task, tmp_path):
    """One centralized epoch over pooled per-pixel / per-token targets
    (a configuration only the port runs: the JAX pooling flattens them),
    its batch order handed over, against plain SGD steps by autograd
    over the loop-pooled rows: parameters within ROUND_TOL of the update,
    the train loss within 1e-5 relative. The eval row against the
    objective (and for segmentation `miou_from_logits`) over the whole
    test set in one batch, within 1e-5."""
    ct, ds = _centralized_case(task, tmp_path)
    tr = CentralizedTrainer(ct, ds, device="cpu")
    t = ct.train_args
    assert (t.client_optimizer, t.momentum, t.weight_decay) == ("sgd", 0, 0)
    x, y = (torch.from_numpy(a) for a in _pool_by_loop(ds))
    assert tuple(tr.pooled["y"].shape[1:]) == ds.y_train.shape[2:]
    rs = np.random.RandomState(3)
    idx = rs.permutation(x.shape[0])[:x.shape[0] // 8 * 8].reshape(-1, 8)
    init = {k: v.clone() for k, v in tr.params.items()}
    obj = alg.make_objective(task)
    p, lsum, cnt = init, 0.0, 0.0
    ones = torch.ones(8)
    for s in torch.from_numpy(idx):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss, _c, n = obj(tr.apply_fn(p, x[s]), y[s], ones)
        grads = torch.autograd.grad(loss, list(p.values()))
        p = {k: v.detach() - t.learning_rate * g
             for (k, v), g in zip(p.items(), grads)}
        lsum, cnt = lsum + float(loss.detach()) * float(n), cnt + float(n)
    row = tr.run(epochs=1, batch_idx=[idx])[-1]
    assert row["train_loss"] == pytest.approx(lsum / cnt, rel=1e-5)
    update = max(float((p[k] - init[k]).abs().max()) for k in p)
    assert update > 0
    for k, v in p.items():
        err = float((tr.params[k] - v).abs().max())
        assert err <= ROUND_TOL * update, (k, err, update)
    xt, yt = torch.from_numpy(ds.x_test), torch.from_numpy(ds.y_test)
    with torch.no_grad():
        logits = tr.apply_fn(tr.params, xt)
    loss, correct, n = obj(logits, yt, torch.ones(yt.shape[0]))
    assert row["test_loss"] == pytest.approx(float(loss), rel=1e-5)
    assert row["test_acc"] == pytest.approx(float(correct / n), rel=1e-5)
    assert ("test_miou" in row) == (task == "segmentation")
    if task == "segmentation":
        miou = float(alg.miou_from_logits(logits, yt,
                                          ds.num_classes)[0])
        assert row["test_miou"] == pytest.approx(miou, rel=1e-5, abs=1e-6)
