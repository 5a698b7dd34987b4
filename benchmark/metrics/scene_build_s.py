"""Host seconds of the scene's set-up: the OBJ load, the tree build and
the copy to the card, synchronized (benchmark/program.scene)."""


def read(run):
    return run.scene_build_s
