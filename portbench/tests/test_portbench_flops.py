"""The FLOP counter against multiply-adds counted by hand."""

from portbench import flops, manifest


def _job(cell, name):
    cfg = manifest.load_cell(cell).config
    return next(j for j in cfg["jobs"] if j["name"] == name)


def test_lenet5_macs_by_hand():
    j = _job("group-a.paper", "lenet5")
    # 5x5 convs at 28x28 (1 -> 6) and 14x14 (6 -> 16), dense 784-120-84-10.
    by_hand = (28 * 28 * 25 * 1 * 6 + 14 * 14 * 25 * 6 * 16
               + 7 * 7 * 16 * 120 + 120 * 84 + 84 * 10)
    assert by_hand == 693_000
    macs = flops.layer_macs(j["cnn_spec"], j["input_shape"], j["num_classes"])
    assert sum(m for _, m in macs) == by_hand


def test_vgg16_macs_by_hand():
    j = _job("group-a.paper", "vgg16")
    convs = [(32, 3, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
             (8, 128, 256), (8, 256, 256), (8, 256, 256),
             (4, 256, 512), (4, 512, 512), (4, 512, 512),
             (2, 512, 512), (2, 512, 512), (2, 512, 512)]
    by_hand = (sum(hw * hw * 9 * ci * co for hw, ci, co in convs)
               + 512 * 4096 + 4096 * 4096 + 4096 * 10)
    assert by_hand == 332_111_872
    macs = flops.layer_macs(j["cnn_spec"], j["input_shape"], j["num_classes"])
    assert sum(m for _, m in macs) == by_hand
    assert flops.forward_flops(j["cnn_spec"], j["input_shape"], 10) \
        == 2 * by_hand
    # Forward, weight and input gradients; the first layer has no input
    # gradient.
    assert flops.train_flops(j["cnn_spec"], j["input_shape"], 10) \
        == 2 * (3 * by_hand - 32 * 32 * 9 * 3 * 64)


def test_resnet18_blocks_by_hand():
    j = _job("group-b.cohort100", "resnet18")
    macs = dict(flops.layer_macs(j["cnn_spec"], j["input_shape"], 10))
    assert macs["0.conv"] == 32 * 32 * 27 * 16
    # The first strided block: 3x3 16 -> 32 at 16x16, 3x3 32 -> 32, and a
    # 1x1 projection.
    assert macs["3.conv1"] == 16 * 16 * 9 * 16 * 32
    assert macs["3.conv2"] == 16 * 16 * 9 * 32 * 32
    assert macs["3.proj"] == 16 * 16 * 16 * 32
    assert "1.proj" not in macs
    assert macs["head"] == 4 * 4 * 128 * 10


def test_every_configured_model_counts():
    for cell in ("group-a.paper", "group-b.cohort100"):
        for j in manifest.load_cell(cell).config["jobs"]:
            assert flops.train_flops(j["cnn_spec"], j["input_shape"],
                                     j["num_classes"]) > 0
