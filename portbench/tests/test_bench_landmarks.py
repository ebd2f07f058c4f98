"""The reference's landmark extraction gives the program's landmarks,
exactly, on the benchmark's films, and the reference reads the training
frames of a fold from the films alone."""

import numpy as np
import pytest

from portbench import films
from portbench.reference import landmarks


@pytest.mark.parametrize("size,patients,seed", [(64, 10, 3), (256, 5, 2 ** 32 + 17)])
def test_reference_landmarks_are_the_programs(size, patients, seed):
    from contouring_uncertainty_torch.data.contour_extraction import get_contour_points

    tree = films.make_camus_tree(patients, 21, size, seed, 5)
    images, points = landmarks.training_frames(tree, 5, 21)
    train = tree.members["cross_validation"].members["fold_5"].members["train"]
    views = [v for pid in train for v in tree.members[pid.decode()].members.values()]
    assert len(images) == len(points) == 2 * len(views)
    want = np.stack([get_contour_points(v.members["gt_proc"][f], 21) for v in views
                     for f in (0, 1)])
    assert points.dtype == want.dtype and np.array_equal(points, want)
    assert np.array_equal(images[:, 0], np.concatenate([v.members["img_proc"] for v in views]))
