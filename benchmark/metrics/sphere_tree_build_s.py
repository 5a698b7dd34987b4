"""Host seconds of the sphere tree's build at set-up
(scene/builder.build_sphere_tree and its copy to the card, synchronized),
as the entry's set-up returns it beside scene_build_s; none from an entry
that builds no sphere tree."""


def read(run):
    return getattr(run, "sphere_tree_build_s", None)
