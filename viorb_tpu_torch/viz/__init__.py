"""Headless visualization (port of viorb_tpu/viz: the reference's
Viewer/FrameDrawer/MapDrawer, src/Viewer.cc:54-120, redesigned as PNG dumps
for display-less hosts, written without matplotlib or PIL)."""

from viorb_tpu_torch.viz.drawers import FrameDrawer, MapDrawer, Viewer
