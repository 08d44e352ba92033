"""The plain reference against the program on the CPU, at the CPU test
model's size in float32, on the benchmark's own weights and inputs."""
import torch

from portbench import core, run
from portbench.reference import colxlip as ref
from portbench.traffic.train import make_pool
from portbench.weights import make_state

CELL = "train.vit-b-16-colxlip.colclip-b256"


def test_towers_match_the_program(small):
    cell = core.load_cell(CELL, 2147483901, 1.0, False, small(CELL))
    device = torch.device("cpu")
    model, _ = core.build_program_model(cell, device, train=False)
    images, texts = make_pool(cell, device, 1)[0]
    params = make_state(cell.geometry, cell.seed, device)
    with torch.no_grad():
        got = model.encode_image(images, normalize=True) + model.encode_text(texts, normalize=True)
    want = (ref.encode_reference(params, cell.geometry, "image", images, 3)
            + ref.encode_reference(params, cell.geometry, "text", texts, 3))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g.float(), w, atol=2e-5, rtol=0)


def test_train_step_matches_the_program(small):
    """Three steps of the program's colclip step against the reference's:
    losses, first gradients, the change and its decay, all to float32
    rounding."""
    record = {}
    assert run.main(["--workload", CELL, "--seed", "2147483902", "--seconds", "0.5",
                     "--trace", "0"], need_card=False, device=torch.device("cpu"),
                    overrides=small(CELL), record=record) == 0
    out = record["readings"]
    assert out["loss_gap"] < 1e-4
    assert out["grad_norm_gap"] < 1e-3
    assert out["change_norm_gap"] < 1e-3
    assert out["decay_gap"] < 1e-3


def test_fp8_rounds_to_e4m3_with_a_straight_through_gradient():
    x = torch.tensor([1.0, 0.3, -448.0, 1e-3], requires_grad=True)
    y = ref.fp8(x)
    assert y[2].item() == -448.0 and y[0].item() == 1.0
    assert y[1].item() != 0.3 and abs(y[1].item() - 0.3) <= 0.3 * 2 ** -4
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(4))
