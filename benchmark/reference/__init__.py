"""The plain references of the benchmark's reconstructions, one module per
update rule, each found by the name a configuration gives under
``reference`` and exposing ``reconstruct``.

Plain PyTorch and numpy, written out here and imported from nowhere
else: silhouettes and cameras in, the 2D signed distance images, the
fused voxel state and the marching-cubes mesh out. It follows the
semantics of the original C++ vacancy (``voxel_carver.cc``,
``marching_cubes.cc``) in the two-pass projective-warp formulation of
the engine under test's ``warp`` engine, with every float expression in
the order that formulation writes it, so an engine that keeps to it
agrees bit for bit. A fault of that formulation itself (where pass 1
and pass 2 sample) is therefore not one it can see.

``store`` (``torch.float32`` by default) is the precision the images and
the state are kept in between stages; ``torch.bfloat16`` gives the
benchmark's control, the same computation one precision lower.
"""
