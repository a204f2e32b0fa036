"""The hash grid's input gradient and its backward (kernels K and L) as a
share of their roofline: the least time of the traced window's work (K
over the sections whose normals the steps and the occupancy updates take,
the program's ``sdf.normal_pts``; L over the steps' kept sections) over
the two kernels' device time, by name."""


def read(r):
    t = sum((r.get("sdf_kernel_s") or {}).values())
    work = r.get("work", {}).get("sdf_s", 0.0)
    if t <= 0 or work <= 0:
        return None
    return 100.0 * work / t
