"""``control.py`` with two more planted faults, of the multi-scale grouping
that the MSG models run, for the limits of a cell on them:

    python3 bench_port/faults_msg.py --workload clusters_msg_k32 --seeds 1 2 --seconds 3 --plant swap_radii

- ``swap_radii``: the first two radii of every multi-scale level traded,
  so that each of those scales groups the other's ball;
- ``drop_scale``: the features of the last scale of every multi-scale level
  left out (zeros in their place).

Every other argument, and the output, is ``control.py``'s.
"""

import sys

import control


def _swap_radii():
    from pointnet_like_pose_estimation_tpu_torch.nn.set_abstraction import SetAbstractionMSG

    init = SetAbstractionMSG.__init__

    def swapped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        r = list(self.radius_list)
        r[0], r[1] = r[1], r[0]
        self.radius_list = tuple(r)

    SetAbstractionMSG.__init__ = swapped


def _drop_scale():
    import torch

    from pointnet_like_pose_estimation_tpu_torch.nn.set_abstraction import SetAbstractionMSG

    forward = SetAbstractionMSG.forward

    def dropped(self, points, features):
        centroids, out = forward(self, points, features)
        last = getattr(self, f"mlp_{len(self.radius_list) - 1}")
        w = getattr(last, f"dense_{last.n - 1}").out_features
        return centroids, torch.cat([out[..., :-w], torch.zeros_like(out[..., -w:])], dim=-1)

    SetAbstractionMSG.forward = dropped


if __name__ == "__main__":
    control.FAULTS.update(swap_radii=_swap_radii, drop_scale=_drop_scale)
    sys.exit(control.main())
