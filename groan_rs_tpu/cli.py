"""gmx-style command-line interface over the analysis suite (surpass —
the reference is a library only; this exposes the device-batched
toolbox as familiar `gmx`-shaped tools).

    python -m groan_rs_tpu <tool> -s conf.tpr -f traj.xtc [options]

Tools mirror their gmx namesakes (rms, rmsf, gyrate, msd, rdf, density,
order, sasa, hbond, dssp, dipoles, potential, velacc, dos, current,
polystat, entropy, covar, cluster, rama, mindist, principal, distance,
angle, traj, trjconv, trjcat, make_ndx, editconf, check, analyze).
Outputs are
.xvg curves (`io.xvg`), trajectories (trjconv/trjcat), structures
(editconf), index files (make_ndx), or plain text; selections are GSL
queries — or ndx group names once `-n index.ndx` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .errors import GroanError

TOOLS = {}


def _tool(name, help_):
    def deco(fn):
        TOOLS[name] = (fn, help_)
        return fn
    return deco


def _common(sp, *, out, traj=True, windowed=False):
    sp.add_argument("-s", "--structure", required=True,
                    help="structure/topology file (tpr/gro/pdb/pqr)")
    if traj:
        sp.add_argument("-f", "--trajectory", required=True, nargs="+",
                        help="trajectory file(s) (xtc/trr/gro/tng/dcd/...)")
    sp.add_argument("-n", "--index", default=None, help="ndx index file")
    sp.add_argument("--sel", default="all",
                    help="selection query or group name (default: all)")
    sp.add_argument("-o", "--output", default=out)
    sp.add_argument("--batch-size", type=int, default=32)
    if windowed:
        sp.add_argument("-b", "--begin", type=float, default=None,
                        help="first time to use (ps)")
        sp.add_argument("-e", "--end", type=float, default=None,
                        help="last time to use (ps)")
        sp.add_argument("--step", type=int, default=None,
                        help="use every Nth frame")


def _system(args):
    from .system import System

    s = System.from_file(args.structure)
    if args.index:
        s.read_ndx(args.index)
    return s


def _group(s, query, name="__cli_sel"):
    """A group name: `query` verbatim if it already names a group, else a
    fresh group compiled from it as a GSL query."""
    from .errors import GroupError

    try:
        s.group_indices(query)
        return query
    except GroupError:
        pass
    # quoted-name semantics for ndx groups with spaces happen in GSL
    n = name
    while n in getattr(s, "groups", {}):
        n += "_"
    s.group_create(n, query)
    return n


def _traj(args):
    t = args.trajectory
    return t[0] if len(t) == 1 else list(t)


def _window(args):
    return {"start_time": getattr(args, "begin", None),
            "end_time": getattr(args, "end", None),
            "step": getattr(args, "step", None),
            "batch_size": args.batch_size}


def _pipe_run(args, build):
    """Build observables on a TrajectoryAnalysis and run the window."""
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    pipe = models.TrajectoryAnalysis(s)
    extra = build(s, g, pipe)
    out = pipe.run(_traj(args), **_window(args))
    return s, g, out, extra


def _xvg(args, columns, *, title, xlabel, ylabel, legends=()):
    from .io.xvg import write_xvg

    write_xvg(args.output, columns, title=title, xlabel=xlabel,
              ylabel=ylabel, legends=legends)
    print(f"wrote {args.output}")


# --------------------------------------------------------------- tools

@_tool("rms", "RMSD of a selection vs the structure over time (gmx rms)")
def _rms(sp=None, args=None):
    if args is None:
        _common(sp, out="rmsd.xvg", windowed=True)
        return
    _, _, out, _ = _pipe_run(
        args, lambda s, g, p: p.add_rmsd(g, s, name="r"))
    _xvg(args, [out["times"], out["r"]], title="RMSD", xlabel="time (ps)",
         ylabel="RMSD (nm)", legends=["rmsd"])


@_tool("rmsf", "per-atom RMS fluctuation (gmx rmsf)")
def _rmsf(sp=None, args=None):
    if args is None:
        _common(sp, out="rmsf.xvg")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    indices, fluct = models.rmsf(s, _traj(args), g,
                                 batch_size=args.batch_size)
    _xvg(args, [np.asarray(indices, np.float64) + 1, fluct],
         title="RMS fluctuation", xlabel="atom", ylabel="RMSF (nm)",
         legends=["rmsf"])


@_tool("gyrate", "radius of gyration over time (gmx gyrate)")
def _gyrate(sp=None, args=None):
    if args is None:
        _common(sp, out="gyrate.xvg", windowed=True)
        sp.add_argument("--components", action="store_true",
                        help="add Rg about the x/y/z axes "
                        "(gmx gyrate's Rg_X/Y/Z columns)")
        return
    _, _, out, _ = _pipe_run(
        args, lambda s, g, p: p.add_gyration(
            g, name="rg", components=args.components))
    if args.components:
        rg = np.asarray(out["rg"], np.float64)
        _xvg(args, [out["times"], rg[:, 0], rg[:, 1], rg[:, 2],
                    rg[:, 3]],
             title="Radius of gyration", xlabel="time (ps)",
             ylabel="Rg (nm)", legends=["Rg", "RgX", "RgY", "RgZ"])
        return
    _xvg(args, [out["times"], out["rg"]], title="Radius of gyration",
         xlabel="time (ps)", ylabel="Rg (nm)", legends=["Rg"])


@_tool("msd", "mean-squared displacement + diffusion fit (gmx msd)")
def _msd(sp=None, args=None):
    if args is None:
        _common(sp, out="msd.xvg")
        sp.add_argument("--beginfit", type=float, default=0.1,
                        help="fit window start (fraction of max lag)")
        sp.add_argument("--endfit", type=float, default=0.9)
        sp.add_argument("--dims", default="xyz",
                        help="displacement axes, e.g. xy = lateral "
                        "(gmx msd -lateral z)")
        sp.add_argument("--mol", default=None, metavar="DIFF_XVG",
                        help="per-molecule COM MSD: write each "
                        "molecule's D here (gmx msd -mol)")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    if args.mol:
        out = models.msd_mol(s, _traj(args), g,
                             fit_range=(args.beginfit, args.endfit),
                             dims=args.dims, batch_size=args.batch_size)
        _xvg(args, [out["lag_times"], out["msd_mean"]],
             title="COM MSD (molecule mean)", xlabel="lag time (ps)",
             ylabel="MSD (nm^2)", legends=["msd"])
        from .io.xvg import write_xvg

        write_xvg(args.mol,
                  [np.arange(out["n_molecules"], dtype=np.float64),
                   out["D_1e5"]],
                  title="Per-molecule diffusion", xlabel="molecule",
                  ylabel="D (1e-5 cm^2/s)", legends=["D"])
        print(f"wrote {args.mol}")
        print(f"D = {out['D_mean'] * 1e5:.6g} +/- "
              f"{out['D_std'] * 1e5:.6g} 1e-5 cm^2/s "
              f"({out['n_molecules']} molecules)")
        return
    out = models.diffusion(s, _traj(args), g,
                           fit_range=(args.beginfit, args.endfit),
                           dims=args.dims, batch_size=args.batch_size)
    _xvg(args, [out["lag_times"], out["msd"]], title="MSD",
         xlabel="lag time (ps)", ylabel="MSD (nm^2)", legends=["msd"])
    print(f"D = {out['D_1e5']:.6g} 1e-5 cm^2/s")


@_tool("rdf", "radial distribution function g(r) (gmx rdf)")
def _rdf(sp=None, args=None):
    if args is None:
        _common(sp, out="rdf.xvg", windowed=True)
        sp.add_argument("--ref", default=None,
                        help="reference selection (default: --sel)")
        sp.add_argument("--rmax", type=float, default=2.0)
        sp.add_argument("--bins", type=int, default=200)
        sp.add_argument("--cn", action="store_true",
                        help="add the cumulative coordination number "
                        "column (gmx rdf -cn)")
        return
    sel_holder = {}

    def build(s, g, p):
        r = _group(s, args.ref, "__cli_ref") if args.ref else g
        p.add_rdf(r, g, r_max=args.rmax, n_bins=args.bins, name="g")
        sel_holder["system"], sel_holder["g"] = s, g
    _, _, out, _ = _pipe_run(args, build)
    r = (np.arange(args.bins) + 0.5) * args.rmax / args.bins
    g_mean = np.asarray(out["g"], np.float64).mean(0)
    cols = [r, g_mean]
    legends = ["g(r)"]
    if args.cn:
        # cn(r) = rho_sel * integral 4 pi r'^2 g(r') dr' to r
        s_, gname = sel_holder["system"], sel_holder["g"]
        n_sel = len(s_.group_indices(gname))
        vol = s_.simbox.x * s_.simbox.y * s_.simbox.z
        dr = args.rmax / args.bins
        shell = 4.0 * np.pi * r ** 2 * dr
        cols.append(np.cumsum(g_mean * shell) * (n_sel / vol))
        legends.append("cn(r)")
    _xvg(args, cols, title="Radial distribution", xlabel="r (nm)",
         ylabel="g(r)", legends=legends)


@_tool("density", "partial density profile along an axis (gmx density)")
def _density(sp=None, args=None):
    if args is None:
        _common(sp, out="density.xvg", windowed=True)
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        sp.add_argument("--mode", default="number",
                        choices=["number", "mass", "charge"])
        sp.add_argument("--bins", type=int, default=100)
        return
    def build(s, g, p):
        p.add_density_profile(g, axis=args.axis, mode=args.mode,
                              n_bins=args.bins, name="d")
    _, _, out, _ = _pipe_run(args, build)
    prof = np.asarray(out["d"], np.float64).mean(0)
    x = (np.arange(args.bins) + 0.5) / args.bins   # box fractions
    _xvg(args, [x, prof], title=f"{args.mode} density",
         xlabel=f"{args.axis} (box fraction)", ylabel="density",
         legends=[args.mode])


@_tool("order", "bond orientational order parameters (gmx order)")
def _order(sp=None, args=None):
    if args is None:
        _common(sp, out="order.xvg")
        sp.add_argument("--axis", default="z")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.order_parameters(s, _traj(args), g, axis=args.axis,
                                  batch_size=args.batch_size)
    _xvg(args, [out["heavy"] + 1, -out["s"]], title="Order parameters",
         xlabel="heavy atom", ylabel="-S_CH", legends=["-S"])


@_tool("sasa", "solvent-accessible surface area over time (gmx sasa)")
def _sasa(sp=None, args=None):
    if args is None:
        _common(sp, out="sasa.xvg")
        sp.add_argument("--probe", type=float, default=0.14)
        sp.add_argument("--ndots", type=int, default=192)
        return
    from . import models

    s = _system(args)
    if not np.asarray(s.topology.has_vdw).any():
        s.guess_elements()
    g = _group(s, args.sel)
    out = models.sasa(s, _traj(args), g, probe=args.probe,
                      n_points=args.ndots, batch_size=args.batch_size)
    t = np.arange(out["total"].shape[0], dtype=np.float64)
    _xvg(args, [t, out["total"]], title="Solvent-accessible surface",
         xlabel="frame", ylabel="area (nm^2)", legends=["total"])


@_tool("hbond", "hydrogen-bond counts over time (gmx hbond)")
def _hbond(sp=None, args=None):
    if args is None:
        _common(sp, out="hbnum.xvg", windowed=True)
        sp.add_argument("--acceptors", required=True,
                        help="acceptor selection (GSL), chain 1")
        sp.add_argument("--donors", required=True,
                        help="donor heavy-atom selection, chain 1")
        sp.add_argument("--hydrogens", required=True,
                        help="donor hydrogen selection, chain 1")
        sp.add_argument("--acceptors2", default=None,
                        help="chain 2 (bonds counted 1->2; default: "
                             "within chain 1)")
        sp.add_argument("--donors2", default=None)
        sp.add_argument("--hydrogens2", default=None)
        sp.add_argument("--cutoff", type=float, default=0.35,
                        help="donor-acceptor distance cutoff (nm)")
        sp.add_argument("--angle", type=float, default=120.0,
                        help="minimum D-H...A angle (deg)")
        sp.add_argument("--dist", default=None,
                        help="write the D-A distance distribution of "
                        "found bonds here (.xvg, gmx hbond -dist)")
        sp.add_argument("--ang", default=None,
                        help="write the D-H...A angle distribution "
                        "here (.xvg, gmx hbond -ang)")
        sp.add_argument("--hist-bins", type=int, default=50)
        sp.add_argument("--life", default=None, metavar="ACF_XVG",
                        help="write existence ACFs here and print "
                        "lifetimes (gmx hbond -ac/-life)")
        return
    from .system.hbonds import HBondChain

    def build(s, g, p):
        chains = [HBondChain(args.acceptors, args.donors, args.hydrogens)]
        if args.acceptors2 or args.donors2 or args.hydrogens2:
            if not (args.acceptors2 and args.donors2 and args.hydrogens2):
                raise GroanError(
                    "--acceptors2/--donors2/--hydrogens2 must be given "
                    "together")
            chains.append(HBondChain(args.acceptors2, args.donors2,
                                     args.hydrogens2))
            p.add_hbonds(chains, [(0, 1)], args.cutoff, args.angle,
                         name="hb")
            return "hb_0_1"
        p.add_hbonds(chains, [(0, 0)], args.cutoff, args.angle, name="hb")
        return "hb_0_0"
    _, _, out, key = _pipe_run(args, build)
    _xvg(args, [out["times"], out[key]], title="Hydrogen bonds",
         xlabel="time (ps)", ylabel="count", legends=["hbonds"])

    if args.dist or args.ang:
        from .io.xvg import write_xvg

        s = _system(args)
        chains = [HBondChain(args.acceptors, args.donors, args.hydrogens)]
        pairs = [(0, 0)]
        if args.acceptors2:
            chains.append(HBondChain(args.acceptors2, args.donors2,
                                     args.hydrogens2))
            pairs = [(0, 1)]
        dists, angs = [], []
        w = _window(args)
        w.pop("batch_size", None)
        for _, hmap in s.hbonds_analyze_batched(
                _traj(args), chains, pairs, args.cutoff, args.angle,
                batch_size=args.batch_size, **w):
            for bonds in hmap.values():
                dists.extend(b.distance for b in bonds)
                angs.extend(b.angle for b in bonds)
        nb = args.hist_bins
        if args.dist:
            h, e = np.histogram(dists, bins=nb, range=(0.0, args.cutoff),
                                density=True)
            write_xvg(args.dist, [0.5 * (e[:-1] + e[1:]), h],
                      title="H-bond D-A distance distribution",
                      xlabel="distance (nm)", ylabel="density (1/nm)",
                      legends=["p(d)"])
        if args.ang:
            h, e = np.histogram(angs, bins=nb, range=(args.angle, 180.0),
                                density=True)
            write_xvg(args.ang, [0.5 * (e[:-1] + e[1:]), h],
                      title="H-bond D-H...A angle distribution",
                      xlabel="angle (deg)", ylabel="density (1/deg)",
                      legends=["p(theta)"])
        print(f"{len(dists)} bonds histogrammed")

    if args.life:
        from . import models
        from .io.xvg import write_xvg

        s = _system(args)
        chains = [HBondChain(args.acceptors, args.donors, args.hydrogens)]
        pairs = [(0, 0)]
        if args.acceptors2:
            chains.append(HBondChain(args.acceptors2, args.donors2,
                                     args.hydrogens2))
            pairs = [(0, 1)]
        life = models.hbond_lifetime(
            s, _traj(args), chains, pairs, max_distance=args.cutoff,
            min_angle=args.angle, **_window(args))
        write_xvg(args.life,
                  [life["lag_times"], life["intermittent"],
                   life["continuous"]],
                  title="H-bond existence ACF", xlabel="lag time (ps)",
                  ylabel="C(t)", legends=["intermittent", "continuous"])
        print(f"wrote {args.life}")
        print(f"tau_intermittent = {life['tau_intermittent']:.4g} ps, "
              f"tau_continuous = {life['tau_continuous']:.4g} ps, "
              f"k_rapaport = 1/tau_c = {life['k_rapaport']:.4g} 1/ps "
              f"({life['n_bonds_seen']} distinct bonds)")


@_tool("dssp", "secondary-structure populations over time (gmx do_dssp)")
def _dssp(sp=None, args=None):
    if args is None:
        _common(sp, out="ss.xvg")
        sp.add_argument("--states", type=int, default=3,
                        choices=[3, 8],
                        help="3 = H/E/- (pydssp), 8 = full DSSP codes")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.dssp(s, _traj(args), g, states=args.states,
                      batch_size=args.batch_size)
    ss = out["ss"]
    t = np.arange(ss.shape[0], dtype=np.float64)
    codes = (("H", "E", "-") if args.states == 3
             else ("H", "G", "I", "E", "B", "T", "S", "-"))
    counts = [np.asarray((ss == c).sum(1), np.float64) for c in codes]
    _xvg(args, [t] + counts, title="Secondary structure",
         xlabel="frame", ylabel="residues",
         legends=[{"H": "helix", "E": "strand", "-": "loop",
                   "G": "3-10", "I": "pi", "B": "bridge", "T": "turn",
                   "S": "bend"}[c] for c in codes])
    print("fractions:", {k: round(v, 4) for k, v in out["frac"].items()})


@_tool("dipoles", "total dipole moment over time (+epsilon) (gmx dipoles)")
def _dipoles(sp=None, args=None):
    if args is None:
        _common(sp, out="Mtot.xvg", windowed=True)
        sp.add_argument("--temperature", type=float, default=None,
                        help="also print the static dielectric constant")
        sp.add_argument("--corr", default=None, choices=["total", "mol"],
                        help="also write the dipole ACF (gmx dipoles -corr)")
        sp.add_argument("--corr-out", default="dipcorr.xvg")
        return
    _, _, out, _ = _pipe_run(
        args, lambda s, g, p: (p.add_total_dipole(g, name="m"),
                               p.add_box_volume(name="v")))
    m = np.asarray(out["m"], np.float64)
    _xvg(args, [out["times"], m[:, 0], m[:, 1], m[:, 2],
                np.linalg.norm(m, axis=1)],
         title="Total dipole moment", xlabel="time (ps)",
         ylabel="M (e nm)", legends=["Mx", "My", "Mz", "|M|"])
    if args.temperature is not None:
        from . import models

        s2 = _system(args)
        g2 = _group(s2, args.sel)
        eps = models.dielectric(s2, _traj(args), g2,
                                temperature=args.temperature,
                                batch_size=args.batch_size)
        print(f"epsilon = {eps['epsilon']:.6g}")
    if args.corr:
        from . import models
        from .io.xvg import write_xvg

        s3 = _system(args)
        g3 = _group(s3, args.sel)
        ac = models.dipole_corr(s3, _traj(args), g3, mode=args.corr,
                                batch_size=args.batch_size)
        write_xvg(args.corr_out, [ac["lag_times"], ac["phi"]],
                  title="Dipole ACF", xlabel="time (ps)", ylabel="phi",
                  legends=[f"phi ({args.corr})"])
        print(f"wrote {args.corr_out} (corr time "
              f"{ac['corr_time']:.4g} ps)")


@_tool("potential", "electrostatic potential profile (gmx potential)")
def _potential(sp=None, args=None):
    if args is None:
        _common(sp, out="potential.xvg")
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        sp.add_argument("--bins", type=int, default=100)
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.potential_profile(s, _traj(args), g, axis=args.axis,
                                   n_bins=args.bins,
                                   batch_size=args.batch_size)
    _xvg(args, [out["centers"], out["psi"]], title="Potential profile",
         xlabel=f"{args.axis} (nm)", ylabel="psi (V)", legends=["psi"])


@_tool("velacc", "velocity autocorrelation (gmx velacc; needs TRR)")
def _velacc(sp=None, args=None):
    if args is None:
        _common(sp, out="vac.xvg")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    times, c = models.vacf(s, _traj(args), g, batch_size=args.batch_size)
    _xvg(args, [times, c], title="Velocity autocorrelation",
         xlabel="lag (ps)", ylabel="C(t) (nm^2/ps^2)", legends=["vacf"])


@_tool("dos", "vibrational density of states (gmx dos; needs TRR)")
def _dos(sp=None, args=None):
    if args is None:
        _common(sp, out="dos.xvg")
        sp.add_argument("--temperature", type=float, default=None)
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.dos(s, _traj(args), g, temperature=args.temperature,
                     batch_size=args.batch_size)
    _xvg(args, [out["nu"], out["dos"]], title="Density of states",
         xlabel="nu (1/ps)", ylabel="S (ps)", legends=["S"])
    print(f"T = {out['T']:.4g} K, D = {out['D']:.6g} cm^2/s, "
          f"dof integral = {out['dof']:.6g}")


@_tool("current", "ionic conductivity, Einstein-Helfand (gmx current)")
def _current(sp=None, args=None):
    if args is None:
        _common(sp, out="current.xvg")
        sp.add_argument("--temperature", type=float, default=300.0)
        sp.add_argument("--beginfit", type=float, default=0.1)
        sp.add_argument("--endfit", type=float, default=0.5)
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.current(s, _traj(args), g, temperature=args.temperature,
                         fit_range=(args.beginfit, args.endfit),
                         batch_size=args.batch_size)
    _xvg(args, [out["lag_times"], out["mj2"]],
         title="Translational dipole MSD", xlabel="lag (ps)",
         ylabel="<|dM|^2> (e^2 nm^2)", legends=["mj2"])
    print(f"sigma = {out['conductivity']:.6g} S/m")


@_tool("polystat", "polymer chain statistics (gmx polystat)")
def _polystat(sp=None, args=None):
    if args is None:
        _common(sp, out="polystat.xvg")
        sp.add_argument("--mw", action="store_true",
                        help="mass-weighted radii of gyration")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.polystat(s, _traj(args), g, mass_weighted=args.mw,
                          batch_size=args.batch_size)
    t = np.arange(len(out["ete"]), dtype=np.float64)
    _xvg(args, [t, out["ete"], np.sqrt(out["rg2"])],
         title="Polymer statistics", xlabel="frame", ylabel="nm",
         legends=["end-to-end", "Rg"])
    print(f"{out['n_chains']} chains, <l_b> = "
          f"{out['mean_bond_length']:.4g} nm, l_p = "
          f"{out['persistence_length']:.4g} nm")


@_tool("entropy", "configurational entropy (gmx anaeig -entropy)")
def _entropy(sp=None, args=None):
    if args is None:
        _common(sp, out="entropy.txt")
        sp.add_argument("--temperature", type=float, default=300.0)
        sp.add_argument("--nofit", action="store_true")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.entropy(s, _traj(args), g, temperature=args.temperature,
                         fit=not args.nofit, batch_size=args.batch_size)
    lines = [f"Schlitter      S = {out['schlitter']:.8g} kJ/(mol K)",
             f"quasiharmonic  S = {out['quasiharmonic']:.8g} kJ/(mol K)"]
    with open(args.output, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("\n".join(lines))


@_tool("covar", "covariance eigenvalues / PCA (gmx covar)")
def _covar(sp=None, args=None):
    if args is None:
        _common(sp, out="eigenval.xvg")
        sp.add_argument("--proj", default=None,
                        help="also write first-2-PC projections here")
        sp.add_argument("--ncomp", type=int, default=None)
        sp.add_argument("--extr", default=None,
                        help="write the min/max-projection extreme "
                        "structures along --extr-pc here (2-frame gro, "
                        "gmx anaeig -extr)")
        sp.add_argument("--extr-pc", type=int, default=1,
                        help="1-based principal component for --extr")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.pca(s, _traj(args), g, n_components=args.ncomp,
                     batch_size=args.batch_size)
    lam = out["eigenvalues"]
    _xvg(args, [np.arange(1, len(lam) + 1, dtype=np.float64), lam],
         title="Covariance eigenvalues", xlabel="index",
         ylabel="eigenvalue (amu nm^2)", legends=["lambda"])
    print(f"trace = {out['trace']:.6g} amu nm^2")
    if args.proj:
        pr = out["projections"]
        t = np.arange(pr.shape[0], dtype=np.float64)
        from .io.xvg import write_xvg

        ncols = min(2, pr.shape[1])
        write_xvg(args.proj, [t] + [pr[:, i] for i in range(ncols)],
                  title="PC projections", xlabel="frame",
                  ylabel="proj (amu^1/2 nm)",
                  legends=[f"PC{i + 1}" for i in range(ncols)])
        print(f"wrote {args.proj}")
    if args.extr:
        pc = args.extr_pc - 1
        if pc < 0 or pc >= out["eigenvalues"].shape[0]:
            raise GroanError(f"--extr-pc {args.extr_pc} out of range")
        gsel = out["indices"]
        sw = np.sqrt(np.asarray(s.topology.mass, np.float64)[gsel])
        pr = out["projections"][:, pc]
        ev = out["eigenvectors"][pc]                  # [K, 3]
        sub = s.group_extract(g)
        from .io.gro import write_gro_frame

        with open(args.extr, "w") as fh:
            for p in (pr.min(), pr.max()):
                sub.positions[:] = (
                    out["mean"] + p * ev / sw[:, None]).astype(np.float32)
                sub.set_time(0.0)
                write_gro_frame(sub, fh, "all", False, True)
        print(f"wrote extremes along PC{args.extr_pc} "
              f"(proj {pr.min():.3f} .. {pr.max():.3f}) to {args.extr}")


@_tool("tcaf", "shear viscosity from transverse currents (gmx tcaf)")
def _tcaf(sp=None, args=None):
    if args is None:
        _common(sp, out="tcaf.xvg")
        sp.add_argument("--nk", type=int, default=4,
                        help="k modes per axis")
        sp.add_argument("--fit-floor", type=float, default=0.3,
                        help="fit ln C while C > floor * C(0)")
        return
    from . import models

    s = _system(args)
    if not np.asarray(s.topology.has_mass).all():
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.guess_elements()
            s.guess_properties()
    g = _group(s, args.sel)
    out = models.tcaf(s, _traj(args), g, n_k=args.nk,
                      fit_floor=args.fit_floor,
                      batch_size=args.batch_size)
    cols = [out["lag_times"]] + [out["tcaf"][m] for m in range(args.nk)]
    _xvg(args, cols, title="Transverse current ACF",
         xlabel="time (ps)", ylabel="C(k,t)/C(k,0)",
         legends=[f"k={kv:.3f}" for kv in out["k"]])
    print(f"eta(k): {np.array2string(out['eta_k'], precision=6)} Pa s; "
          f"eta0 = {out['eta0']:.6g} Pa s")


@_tool("helixorient", "local helix axes / rise / twist (gmx helixorient)")
def _helixorient(sp=None, args=None):
    if args is None:
        _common(sp, out="helix.xvg")
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.helixorient(s, _traj(args), g, axis=args.axis,
                             batch_size=args.batch_size)
    t = np.arange(out["tilt"].shape[0], dtype=np.float64)
    _xvg(args, [t, out["tilt"], out["rise"], out["twist"],
                out["radius"]],
         title="Helix geometry", xlabel="frame",
         ylabel="tilt (deg) / rise (nm) / twist (deg) / radius (nm)",
         legends=["tilt", "rise", "twist", "radius"])
    print(f"mean tilt {out['tilt'].mean():.2f} deg, rise "
          f"{out['rise'].mean():.4f} nm, twist {out['twist'].mean():.2f}"
          f" deg, radius {out['radius'].mean():.4f} nm")


@_tool("filter", "low-pass filter a trajectory (gmx filter)")
def _filter(sp=None, args=None):
    if args is None:
        _common(sp, out="filtered.xtc")
        sp.add_argument("--window", type=int, default=5,
                        help="odd cosine-window width in frames")
        sp.add_argument("--wrap", action="store_true",
                        help="rewrap smoothed coordinates into the box")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    n = models.filter_traj(s, _traj(args), args.output, window=args.window,
                           group=g, wrap=args.wrap,
                           batch_size=args.batch_size)
    print(f"wrote {n} filtered frames to {args.output}")


@_tool("rotmat", "least-squares fit rotation matrices (gmx rotmat)")
def _rotmat(sp=None, args=None):
    if args is None:
        _common(sp, out="rotmat.xvg")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.rotmat(s, _traj(args), g, batch_size=args.batch_size)
    m = np.asarray(out["matrices"], np.float64)   # [F, 3, 3]
    t = np.arange(m.shape[0], dtype=np.float64)
    cols = [t] + [m[:, i, j] for i in range(3) for j in range(3)]
    _xvg(args, cols, title="Fit rotation matrix", xlabel="frame",
         ylabel="matrix element",
         legends=[f"{a}{b}" for a in "xyz" for b in "xyz"])


@_tool("dccm", "dynamic cross-correlation matrix of fluctuations")
def _dccm(sp=None, args=None):
    if args is None:
        _common(sp, out="dccm.dat")
        sp.add_argument("--no-fit", action="store_true",
                        help="translate only, skip the rotational fit")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.dccm(s, _traj(args), g, fit=not args.no_fit,
                      batch_size=args.batch_size)
    m = out["dccm"]
    np.savetxt(args.output, m, fmt="%.6f",
               header=f"DCCM [{m.shape[0]} x {m.shape[1]}] of selection "
                      f"'{args.sel}'; row/col order = "
                      "group atom order (see indices)")
    print(f"wrote {args.output} ({m.shape[0]}x{m.shape[1]})")


@_tool("cluster", "conformational clustering (gmx cluster)")
def _cluster(sp=None, args=None):
    if args is None:
        _common(sp, out="clusters.txt")
        sp.add_argument("--cutoff", type=float, default=0.1,
                        help="RMSD cutoff (nm)")
        sp.add_argument("--method", default="gromos",
                        choices=["gromos", "linkage", "jarvis-patrick"])
        sp.add_argument("--jp-m", type=int, default=10,
                        help="jarvis-patrick nearest-neighbour count")
        sp.add_argument("--jp-p", type=int, default=3,
                        help="jarvis-patrick shared-neighbour minimum")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.cluster(s, _traj(args), g, cutoff=args.cutoff,
                         method=args.method, jp_m=args.jp_m,
                         jp_p=args.jp_p, batch_size=args.batch_size)
    labels = np.asarray(out["labels"])
    n_cl = len(out["centers"])
    with open(args.output, "w") as fh:
        fh.write(f"# {n_cl} clusters, method {args.method}, cutoff {args.cutoff} nm\n")
        for i, (center, size) in enumerate(
                zip(out["centers"], out["sizes"])):
            members = np.nonzero(labels == i)[0]
            fh.write(f"cluster {i}: center frame {center}, "
                     f"{size} members: "
                     + " ".join(map(str, members.tolist())) + "\n")
    print(f"{n_cl} clusters; wrote {args.output}")


@_tool("freevolume", "free volume by MC probe insertion (gmx freevolume)")
def _freevolume(sp=None, args=None):
    if args is None:
        _common(sp, out="freevolume.xvg")
        sp.add_argument("--probe", type=float, default=0.0,
                        help="probe radius (nm)")
        sp.add_argument("--samples", type=int, default=8192,
                        help="insertion points per frame")
        sp.add_argument("--seed", type=int, default=0)
        return
    from . import models

    s = _system(args)
    if not np.asarray(s.topology.has_vdw).any():
        s.guess_elements()
    g = _group(s, args.sel)
    out = models.freevolume(s, _traj(args), g, probe=args.probe,
                            n_samples=args.samples, seed=args.seed,
                            batch_size=args.batch_size)
    t = np.arange(out["fraction"].shape[0], dtype=np.float64)
    _xvg(args, [t, out["fraction"], out["free_volume"]],
         title=f"Free volume (probe {args.probe} nm)", xlabel="frame",
         ylabel="fraction / nm^3", legends=["fraction", "free volume"])
    print(f"mean free-volume fraction {out['mean_fraction']:.4f} "
          f"+- {out['stderr_fraction']:.4f} "
          f"({out['n_samples']} samples/frame)")


@_tool("densmap", "2D density map (gmx densmap)")
def _densmap(sp=None, args=None):
    if args is None:
        _common(sp, out="densmap.dat")
        sp.add_argument("--axes", default="xy",
                        help="map plane: xy, xz, or yz (default xy)")
        sp.add_argument("--bins", type=int, nargs=2, default=[100, 100],
                        metavar=("NX", "NY"))
        sp.add_argument("--weights", default="number",
                        choices=["number", "mass", "charge"])
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.densmap(s, _traj(args), g, axes=args.axes,
                         bins=tuple(args.bins), weights=args.weights,
                         batch_size=args.batch_size)
    out["map"].save(args.output)
    print(f"{args.bins[0]}x{args.bins[1]} {args.axes} map "
          f"({args.weights} density, nm^-3); wrote {args.output}")


@_tool("vanhove", "Van Hove self-correlation Gs(r,t) (gmx vanhove)")
def _vanhove(sp=None, args=None):
    if args is None:
        _common(sp, out="vanhove.xvg")
        sp.add_argument("--lags", type=int, nargs="+", default=None,
                        help="frame lags (default 1..min(F-1,50))")
        sp.add_argument("--rmax", type=float, default=2.0)
        sp.add_argument("--bins", type=int, default=100)
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.vanhove(s, _traj(args), g, lags=args.lags,
                         r_max=args.rmax, bins=args.bins,
                         batch_size=args.batch_size)
    cols = [out["r"]] + [out["gs"][i] for i in range(len(out["lags"]))]
    _xvg(args, cols, title="Van Hove self-correlation",
         xlabel="r (nm)", ylabel="Gs(r,t) (1/nm)",
         legends=[f"lag {int(lg)}" for lg in out["lags"]])
    print(f"{len(out['lags'])} lags; max overflow fraction "
          f"{float(out['overflow'].max()):.4f}")


@_tool("rmsdist", "RMS deviation of atom-pair distances (gmx rmsdist)")
def _rmsdist(sp=None, args=None):
    if args is None:
        _common(sp, out="rmsdist.xvg")
        sp.add_argument("--mean-matrix", default=None,
                        help="also write the mean |deviation| matrix "
                        "(whitespace text) to this path")
        sp.add_argument("--pbc", action="store_true",
                        help="min-image distances (surpass option)")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.rmsdist(s, _traj(args), g, pbc_aware=args.pbc,
                         batch_size=args.batch_size)
    t = np.arange(out["rmsdist"].shape[0], dtype=np.float64)
    _xvg(args, [t, out["rmsdist"]], title="RMS distance deviation",
         xlabel="frame", ylabel="RMSdist (nm)", legends=["rmsdist"])
    if args.mean_matrix:
        np.savetxt(args.mean_matrix, out["mean_deviation"], fmt="%.6f")
        print(f"wrote mean-deviation matrix to {args.mean_matrix}")
    print(f"mean RMSdist {float(out['rmsdist'].mean()):.6f} nm")


@_tool("saxs", "SAXS intensity by the Debye formula (gmx saxs)")
def _saxs(sp=None, args=None):
    if args is None:
        _common(sp, out="saxs.xvg")
        sp.add_argument("--qmin", type=float, default=0.06)
        sp.add_argument("--qmax", type=float, default=6.0)
        sp.add_argument("--nq", type=int, default=60)
        return
    from . import models

    s = _system(args)
    if not any(s.topology.element_symbol[i]
               for i in range(min(10, s.topology.n_atoms))):
        s.guess_elements()
    g = _group(s, args.sel)
    q = np.linspace(args.qmin, args.qmax, args.nq)
    out = models.saxs(s, _traj(args), g, q=q,
                      batch_size=args.batch_size)
    _xvg(args, [out["q"], out["intensity"]], title="SAXS (Debye)",
         xlabel="q (1/nm)", ylabel="I(q) (e^2)", legends=["I(q)"])
    print(f"I(0) bound {out['i0']:.1f} e^2; "
          f"I(qmin) {float(out['intensity'][0]):.1f} e^2")


@_tool("sans", "SANS intensity by the Debye formula (gmx sans)")
def _sans(sp=None, args=None):
    if args is None:
        _common(sp, out="sans.xvg")
        sp.add_argument("--qmin", type=float, default=0.06)
        sp.add_argument("--qmax", type=float, default=6.0)
        sp.add_argument("--nq", type=int, default=60)
        sp.add_argument("--deuterate", action="store_true",
                        help="swap H scattering lengths for D")
        return
    from . import models

    s = _system(args)
    if not any(s.topology.element_symbol[i]
               for i in range(min(10, s.topology.n_atoms))):
        s.guess_elements()
    g = _group(s, args.sel)
    q = np.linspace(args.qmin, args.qmax, args.nq)
    out = models.sans(s, _traj(args), g, q=q, deuterate=args.deuterate,
                      batch_size=args.batch_size)
    _xvg(args, [out["q"], out["intensity"]], title="SANS (Debye)",
         xlabel="q (1/nm)", ylabel="I(q) (fm^2)", legends=["I(q)"])
    print(f"I(0) bound {out['i0']:.1f} fm^2")


@_tool("sham", "free-energy landscape from 2D projections (gmx sham)")
def _sham(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--file", required=True,
                        help=".xvg with the two reaction coordinates "
                        "(e.g. covar --proj output)")
        sp.add_argument("--cols", type=int, nargs=2, default=[1, 2],
                        help="data columns holding the coordinates")
        sp.add_argument("--bins", type=int, nargs=2, default=[32, 32])
        sp.add_argument("--temp", type=float, default=300.0)
        sp.add_argument("-o", "--output", default="gibbs.dat",
                        help="GridMap text output of G (kJ/mol)")
        return
    from .io.xvg import read_xvg
    from .core.gridmap import GridMap
    from .models.pipeline import _KB_KJ

    data = read_xvg(args.file)
    c1, c2 = args.cols
    if data.ndim != 2 or data.shape[1] <= max(c1, c2):
        raise GroanError(f"'{args.file}' lacks columns {c1}/{c2}")
    x, y = data[:, c1], data[:, c2]
    nx, ny = args.bins
    h, ex, ey = np.histogram2d(x, y, bins=(nx, ny))
    kt = _KB_KJ * args.temp
    with np.errstate(divide="ignore"):
        g = -kt * np.log(h / h.max())
    g[h == 0] = g[h > 0].max() + kt       # empty bins: above the max
    bwx, bwy = ex[1] - ex[0], ey[1] - ey[0]
    gm = GridMap.from_vec(
        (ex[0] + bwx / 2, ex[-1] - bwx / 2),
        (ey[0] + bwy / 2, ey[-1] - bwy / 2),
        (bwx, bwy), g.reshape(-1), data_order="row")
    gm.save(args.output)
    print(f"{int((h > 0).sum())}/{nx * ny} bins sampled, "
          f"G range 0..{float(g[h > 0].max()):.3f} kJ/mol; "
          f"wrote {args.output}")


@_tool("wham", "umbrella-sampling PMF by WHAM (gmx wham)")
def _wham(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--files", required=True, nargs="+",
                        help="pullx-style .xvg files (time, coordinate)")
        sp.add_argument("--centers", required=True, type=float, nargs="+",
                        help="umbrella centers (nm), one per file")
        sp.add_argument("--k", required=True, type=float, nargs="+",
                        help="force constants (kJ/mol/nm^2), one per "
                        "file or a single shared value")
        sp.add_argument("--bins", type=int, default=200)
        sp.add_argument("--temp", type=float, default=300.0)
        sp.add_argument("--min", dest="xmin", type=float, default=None)
        sp.add_argument("--max", dest="xmax", type=float, default=None)
        sp.add_argument("--col", type=int, default=1,
                        help="data column holding the coordinate")
        sp.add_argument("-o", "--output", default="pmf.xvg")
        return
    from . import models
    from .io.xvg import read_xvg

    if len(args.centers) != len(args.files):
        raise GroanError("need one --centers value per file")
    ks = args.k if len(args.k) > 1 else args.k * len(args.files)
    if len(ks) != len(args.files):
        raise GroanError("--k takes one value per file or one shared")
    windows = []
    for path, x0, k in zip(args.files, args.centers, ks):
        data = read_xvg(path)
        if data.ndim != 2 or data.shape[1] <= args.col:
            raise GroanError(f"'{path}' has no column {args.col}")
        windows.append({"samples": data[:, args.col], "center": x0,
                        "k": k})
    span = None
    if args.xmin is not None or args.xmax is not None:
        if args.xmin is None or args.xmax is None:
            raise GroanError("--min and --max must be given together")
        span = (args.xmin, args.xmax)
    out = models.wham(windows, bins=args.bins, span=span,
                      temperature=args.temp)
    ok = np.isfinite(out["pmf"])
    _xvg(args, [out["x"][ok], out["pmf"][ok]], title="WHAM PMF",
         xlabel="coordinate (nm)", ylabel="PMF (kJ/mol)",
         legends=["PMF"])
    print(f"{'converged' if out['converged'] else 'NOT converged'} in "
          f"{out['n_iter']} iterations; {int(ok.sum())}/{args.bins} "
          "bins sampled")


@_tool("sorient", "solvent orientation around a group (gmx sorient)")
def _sorient(sp=None, args=None):
    if args is None:
        _common(sp, out="sorient.xvg")
        sp.add_argument("--oxygen", default="name OW")
        sp.add_argument("--hydrogens", default="name HW1 HW2")
        sp.add_argument("--rmin", type=float, default=0.0)
        sp.add_argument("--rmax", type=float, default=0.5)
        sp.add_argument("--bins", type=int, default=40)
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.sorient(s, _traj(args), g, oxygen=args.oxygen,
                         hydrogens=args.hydrogens, rmin=args.rmin,
                         rmax=args.rmax, bins=args.bins,
                         batch_size=args.batch_size)
    c = 0.5 * (out["cos1_edges"][:-1] + out["cos1_edges"][1:])
    _xvg(args, [c, out["cos1_hist"], out["cos2_hist"]],
         title="Solvent orientation", xlabel="cos theta",
         ylabel="probability density",
         legends=["dipole (theta1)", "O-H (theta2)"])
    print(f"{int(out['n_selected'])} water-frames in "
          f"({args.rmin}, {args.rmax}] nm; <cos1> "
          f"{out['mean_cos1']:.4f}, <cos2> {out['mean_cos2']:.4f}")


@_tool("h2order", "water dipole orientation per slab (gmx h2order)")
def _h2order(sp=None, args=None):
    if args is None:
        _common(sp, out="order.xvg")
        sp.add_argument("--oxygen", default="name OW")
        sp.add_argument("--hydrogens", default="name HW1 HW2")
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        sp.add_argument("--bins", type=int, default=50)
        return
    from . import models

    s = _system(args)
    out = models.h2order(s, _traj(args), oxygen=args.oxygen,
                         hydrogens=args.hydrogens, axis=args.axis,
                         bins=args.bins, batch_size=args.batch_size)
    ok = out["count"] > 0
    _xvg(args, [out["z"][ok], out["cos"][ok], out["count"][ok]],
         title="Water dipole orientation",
         xlabel=f"{args.axis} (nm)", ylabel="<cos(dipole, axis)>",
         legends=["cos", "count"])
    print(f"{int(ok.sum())}/{args.bins} slabs occupied")


@_tool("spatial", "3D spatial distribution function (gmx spatial)")
def _spatial(sp=None, args=None):
    if args is None:
        _common(sp, out="sdf.cube")
        sp.add_argument("--ref", required=True,
                        help="reference group/selection (cube center)")
        sp.add_argument("--side", type=float, default=2.0,
                        help="cube side (nm)")
        sp.add_argument("--bins", type=int, default=32)
        sp.add_argument("--fit", action="store_true",
                        help="rotational fit of the reference")
        sp.add_argument("--weights", default="number",
                        choices=["number", "mass"])
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    r = _group(s, args.ref, "__cli_ref")
    out = models.sdf(s, _traj(args), g, r, side=args.side,
                     bins=args.bins, fit=args.fit, weights=args.weights,
                     batch_size=args.batch_size)
    models.write_cube(args.output, out["grid"], out["origin"],
                      out["voxel"])
    print(f"{args.bins}^3 voxels, occupancy {out['occupancy']:.3f}; "
          f"wrote {args.output}")


@_tool("confrms", "fit one structure onto another (gmx confrms)")
def _confrms(sp=None, args=None):
    if args is None:
        sp.add_argument("-f1", "--reference", required=True,
                        help="reference structure (tpr/gro/pdb/pqr)")
        sp.add_argument("-f2", "--structure", required=True,
                        help="structure to fit")
        sp.add_argument("-n", "--index", default=None,
                        help="ndx file (read into BOTH systems)")
        sp.add_argument("--sel", default="all",
                        help="fit selection (GSL or group name)")
        sp.add_argument("-o", "--output", default="fit.gro",
                        help="fitted structure (gro/pdb/pqr)")
        return
    from .system import System

    ref = System.from_file(args.reference)
    s = System.from_file(args.structure)
    if args.index:
        ref.read_ndx(args.index)
        s.read_ndx(args.index)
    gr = _group(ref, args.sel)
    gs = _group(s, args.sel)
    # gro/pdb structures carry no masses: guess them for the fit
    for sys_ in (ref, s):
        if not np.asarray(sys_.topology.has_mass).all():
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sys_.guess_elements()
                sys_.guess_properties()
    if len(ref.group_indices(gr)) != len(s.group_indices(gs)):
        raise GroanError(
            f"selection '{args.sel}' matches {len(ref.group_indices(gr))}"
            f" atoms in {args.reference} but {len(s.group_indices(gs))} "
            f"in {args.structure}")
    rmsd = s.calc_rmsd_and_fit(ref, gr)
    import os

    ext = os.path.splitext(args.output)[1].lower()
    if ext == ".pdb":
        s.write_pdb(args.output)
    elif ext == ".pqr":
        s.write_pqr(args.output)
    else:
        s.write_gro(args.output)
    print(f"RMSD after fit: {rmsd:.6f} nm; wrote {args.output}")


@_tool("insert-molecules", "insert molecules without clashes "
       "(gmx insert-molecules)")
def _insert_molecules(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--structure", required=True,
                        help="host structure (box taken from here)")
        sp.add_argument("--ci", required=True,
                        help="molecule structure to insert")
        sp.add_argument("--nmol", type=int, required=True)
        sp.add_argument("--radius", type=float, default=0.21)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--tries", type=int, default=1000)
        sp.add_argument("-o", "--output", default="out.gro")
        return
    from . import models
    from .system import System

    s = System.from_file(args.structure)
    mol = System.from_file(args.ci)
    out, n = models.insert_molecules(s, mol, args.nmol,
                                     radius=args.radius, seed=args.seed,
                                     tries=args.tries)
    _write_structure(out, args.output)
    print(f"inserted {n} molecules ({out.get_n_atoms()} atoms total); "
          f"wrote {args.output}")


@_tool("solvate", "fill the box with solvent (gmx solvate)")
def _solvate(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--structure", required=True,
                        help="solute structure (box taken from here)")
        sp.add_argument("--cs", required=True,
                        help="pre-equilibrated solvent box structure")
        sp.add_argument("--radius", type=float, default=0.24)
        sp.add_argument("-o", "--output", default="solvated.gro")
        return
    from . import models
    from .system import System

    s = System.from_file(args.structure)
    solvent = System.from_file(args.cs)
    out, n = models.solvate(s, solvent, radius=args.radius)
    _write_structure(out, args.output)
    print(f"added {n} solvent molecules ({out.get_n_atoms()} atoms "
          f"total); wrote {args.output}")


@_tool("genconf", "replicate a structure on a grid (gmx genconf)")
def _genconf(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--structure", required=True)
        sp.add_argument("--nbox", type=int, nargs=3, required=True,
                        metavar=("NX", "NY", "NZ"))
        sp.add_argument("--dist", type=float, nargs=3, default=None,
                        metavar=("DX", "DY", "DZ"),
                        help="extra spacing between copies (nm)")
        sp.add_argument("-o", "--output", default="out.gro")
        return
    from . import models
    from .system import System

    s = System.from_file(args.structure)
    out = models.genconf(s, args.nbox, dist=args.dist)
    _write_structure(out, args.output)
    print(f"{int(np.prod(args.nbox))} copies, {out.get_n_atoms()} atoms; "
          f"wrote {args.output}")


@_tool("genion", "replace solvent with ions (gmx genion)")
def _genion(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--structure", required=True)
        sp.add_argument("--np", dest="n_pos", type=int, default=0)
        sp.add_argument("--nn", dest="n_neg", type=int, default=0)
        sp.add_argument("--pname", default="NA")
        sp.add_argument("--nname", default="CL")
        sp.add_argument("--solvent", default="resname SOL")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("-o", "--output", default="ions.gro")
        return
    from . import models
    from .system import System

    s = System.from_file(args.structure)
    out, ions = models.genion(s, args.n_pos, args.n_neg,
                              solvent=args.solvent, positive=args.pname,
                              negative=args.nname, seed=args.seed)
    _write_structure(out, args.output)
    print(f"replaced {len(ions)} solvent molecules with "
          f"{args.n_pos} {args.pname} + {args.n_neg} {args.nname}; "
          f"wrote {args.output}")


def _write_structure(system, path):
    import os

    ext = os.path.splitext(path)[1].lower()
    if ext == ".pdb":
        system.write_pdb(path)
    elif ext == ".pqr":
        system.write_pqr(path)
    else:
        system.write_gro(path)


@_tool("clustsize", "aggregate cluster sizes over time (gmx clustsize)")
def _clustsize(sp=None, args=None):
    if args is None:
        _common(sp, out="clustsize.xvg")
        sp.add_argument("--cutoff", type=float, default=0.35,
                        help="contact cutoff (nm)")
        sp.add_argument("--mode", choices=["molecule", "atom"],
                        default="molecule")
        sp.add_argument("--hist", default=None,
                        help="also write the cluster-size histogram here")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.clustsize(s, _traj(args), g, cutoff=args.cutoff,
                           mode=args.mode, batch_size=args.batch_size)
    _xvg(args, [out["times"],
                out["n_clusters"].astype(np.float64),
                out["max_size"].astype(np.float64),
                out["mean_size"], out["mean_size_w"]],
         title=f"Cluster sizes ({args.mode}s, cutoff {args.cutoff} nm)",
         xlabel="time (ps)", ylabel="count / size",
         legends=["N clusters", "max size", "<S>", "<S^2>/<S>"])
    print(f"{out['n_entities']} {args.mode} entities; "
          f"largest cluster {int(out['max_size'].max())}")
    if args.hist:
        from .io.xvg import write_xvg

        h = out["size_hist"]
        sz = np.arange(len(h), dtype=np.float64)
        write_xvg(args.hist, [sz, h.astype(np.float64)],
                  title="Cluster size distribution", xlabel="size",
                  ylabel="count", legends=["clusters"])
        print(f"wrote {args.hist}")


@_tool("rama", "Ramachandran phi/psi angles (gmx rama)")
def _rama(sp=None, args=None):
    if args is None:
        _common(sp, out="rama.xvg")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.ramachandran(s, _traj(args), g,
                              batch_size=args.batch_size)
    phi = np.asarray(out["phi"], np.float64).ravel()
    psi = np.asarray(out["psi"], np.float64).ravel()
    _xvg(args, [phi, psi], title="Ramachandran", xlabel="phi (deg)",
         ylabel="psi (deg)", legends=["psi"])


@_tool("mindist", "minimum distance between selections (gmx mindist)")
def _mindist(sp=None, args=None):
    if args is None:
        _common(sp, out="mindist.xvg", windowed=True)
        sp.add_argument("--ref", default=None, help="second selection")
        sp.add_argument("--pi", action="store_true",
                        help="min distance to the group's own periodic "
                        "images + max internal distance (gmx mindist -pi)")
        return
    if args.pi:
        from . import models

        s = _system(args)
        w = _window(args)
        out = models.pi_mindist(s, _traj(args), args.sel, **w)
        _xvg(args, [out["times"], out["min_image"], out["max_internal"]],
             title="Periodic image distance", xlabel="time (ps)",
             ylabel="distance (nm)", legends=["min image", "max internal"])
        return
    if not args.ref:
        raise GroanError("mindist needs --ref (or --pi)")
    def build(s, g, p):
        r = _group(s, args.ref, "__cli_ref")
        p.add_min_distance(g, r, name="d")
    _, _, out, _ = _pipe_run(args, build)
    _xvg(args, [out["times"], out["d"]], title="Minimum distance",
         xlabel="time (ps)", ylabel="distance (nm)", legends=["dmin"])


@_tool("principal", "principal moments of inertia (gmx principal)")
def _principal(sp=None, args=None):
    if args is None:
        _common(sp, out="moi.xvg", windowed=True)
        return
    _, _, out, _ = _pipe_run(
        args, lambda s, g, p: p.add_principal(g, name="i"))
    moi = np.asarray(out["i"], np.float64)
    _xvg(args, [out["times"], moi[:, 0], moi[:, 1], moi[:, 2]],
         title="Principal moments", xlabel="time (ps)",
         ylabel="I (amu nm^2)", legends=["I1", "I2", "I3"])


@_tool("trjconv", "convert/transform trajectories (gmx trjconv)")
def _trjconv(sp=None, args=None):
    if args is None:
        _common(sp, out="trajout.xtc", windowed=True)
        sp.add_argument("--pbc", default="none",
                        choices=["none", "whole", "nojump"],
                        help="whole = rejoin molecules; nojump = unwrap")
        sp.add_argument("--center", default=None,
                        help="selection to center in the box each frame")
        sp.add_argument("--fit", default=None,
                        help="selection to RMSD-fit each frame onto the "
                             "structure")
        sp.add_argument("--trans", type=float, nargs=3, default=None,
                        metavar=("DX", "DY", "DZ"),
                        help="translate all atoms each frame (nm)")
        sp.add_argument("--wrap", action="store_true",
                        help="wrap atoms into the box (after transforms)")
        sp.add_argument("--outfmt", default=None,
                        help="output format override (xtc/trr/gro/tng)")
        sp.add_argument("--dump", type=float, default=None,
                        help="write ONLY the frame nearest this time "
                        "(ps; gmx trjconv -dump)")
        sp.add_argument("--split", type=float, default=None,
                        help="start a new numbered output file every "
                        "this many ps (gmx trjconv -split)")
        sp.add_argument("--sep", action="store_true",
                        help="write each frame to its own numbered "
                        "file (gmx trjconv -sep)")
        return
    from .models.convert import (CenterConverter, FitConverter,
                                 MakeWholeConverter, TranslateConverter,
                                 UnwrapConverter, WrapConverter)

    if args.split is not None and args.split <= 0:
        raise GroanError(f"--split must be a positive time interval in "
                         f"ps (got {args.split:g})")
    if args.split is not None and args.sep:
        raise GroanError("--sep and --split are mutually exclusive "
                         "(one file per frame vs one file per interval)")

    s = _system(args)
    g = _group(s, args.sel)
    convs = []
    if args.pbc == "whole":
        convs.append(MakeWholeConverter())
    elif args.pbc == "nojump":
        convs.append(UnwrapConverter())
    if args.trans is not None:
        convs.append(TranslateConverter(np.asarray(args.trans, np.float32)))
    if args.center:
        convs.append(CenterConverter(_group(s, args.center, "__cli_center")))
    if args.fit:
        # create the group BEFORE copying: the reference copy must carry it
        fit_g = _group(s, args.fit, "__cli_fit")
        convs.append(FitConverter(s.copy(), fit_g))
    if args.wrap:
        convs.append(WrapConverter())

    from .models.convert import convert_iter

    w = _window(args)
    files = _traj(args)
    reader = (s.traj_cat_iter(files, **w) if isinstance(files, list)
              else s.traj_iter(files, **w))

    if args.dump is not None:
        best = None
        for _ in convert_iter(reader, convs):
            t = s.get_time()
            d = abs(t - args.dump)
            if best is None or d < best[0]:
                best = (d, s.positions.copy(), s.get_box_copy(), t)
        if best is None:
            raise GroanError("trajectory has no frames in the window")
        _, pos, box, t = best
        s.positions[:] = pos
        s.set_box(box)
        s.set_time(t)
        s.group_traj_writer_init(g, args.output, fmt=args.outfmt)
        try:
            s.traj_write_frame()
        finally:
            s.traj_writers_close()
        print(f"wrote frame at t={t:g} ps (requested {args.dump:g}) "
              f"to {args.output}")
        return

    import os as _os

    def _numbered(path, i):
        root, ext = _os.path.splitext(path)
        return f"{root}.part{i:04d}{ext}"

    n = 0
    seg = None
    seg_t0 = None
    writer_open = False
    written = []

    def _open(path):
        s.group_traj_writer_init(g, path, fmt=args.outfmt)
        written.append(path)

    try:
        for _ in convert_iter(reader, convs):
            t = s.get_time()
            if args.sep:
                if writer_open:
                    s.traj_writers_close()
                _open(_numbered(args.output, n))
                writer_open = True
            elif args.split is not None:
                if seg_t0 is None:
                    seg_t0 = t
                want = int((t - seg_t0) // args.split)
                if want != seg:
                    if writer_open:
                        s.traj_writers_close()
                    seg = want
                    _open(_numbered(args.output, seg))
                    writer_open = True
            elif not writer_open:
                _open(args.output)
                writer_open = True
            s.traj_write_frame()
            n += 1
    finally:
        if writer_open:
            s.traj_writers_close()
    if len(written) == 1:
        print(f"wrote {n} frames to {written[0]}")
    else:
        print(f"wrote {n} frames to {len(written)} files "
              f"({written[0]} .. {written[-1]})" if written
              else "wrote 0 frames")


@_tool("trjcat", "concatenate trajectories, dedup boundaries (gmx trjcat)")
def _trjcat(sp=None, args=None):
    if args is None:
        _common(sp, out="trajcat.xtc", windowed=True)
        sp.add_argument("--outfmt", default=None,
                        help="output format override (xtc/trr/gro/tng)")
        return
    s = _system(args)
    g = _group(s, args.sel)
    files = _traj(args)
    reader = s.traj_cat_iter(files if isinstance(files, list) else [files],
                             **_window(args))
    s.group_traj_writer_init(g, args.output, fmt=args.outfmt)
    n = 0
    try:
        for _ in reader:
            s.traj_write_frame()
            n += 1
    finally:
        s.traj_writers_close()
    print(f"wrote {n} frames to {args.output}")


@_tool("make_ndx", "create index groups from selections (gmx make_ndx)")
def _make_ndx(sp=None, args=None):
    if args is None:
        sp.add_argument("-s", "--structure", required=True)
        sp.add_argument("-n", "--index", default=None,
                        help="existing ndx to extend")
        sp.add_argument("--group", action="append", default=[],
                        metavar="NAME=QUERY", required=True,
                        help="group to create (repeatable)")
        sp.add_argument("-o", "--output", default="index.ndx")
        return
    s = _system(args)
    for spec in args.group:
        name, sep, query = spec.partition("=")
        if not sep or not name or not query:
            raise GroanError(f"--group expects NAME=QUERY, got '{spec}'")
        s.group_create(name.strip(), query)
    s.write_ndx(args.output)
    print(f"wrote {len(args.group)} new group(s) to {args.output}")


@_tool("editconf", "convert/transform structure files (gmx editconf)")
def _editconf(sp=None, args=None):
    if args is None:
        _common(sp, out="out.gro", traj=False)
        sp.add_argument("--whole", action="store_true",
                        help="make molecules whole first")
        sp.add_argument("--trans", type=float, nargs=3, default=None,
                        metavar=("DX", "DY", "DZ"))
        sp.add_argument("--center", default=None,
                        help="selection to center in the box")
        sp.add_argument("--wrap", action="store_true")
        sp.add_argument("--velocities", action="store_true",
                        help="write velocities (gro output)")
        sp.add_argument("--conect", action="store_true",
                        help="write CONECT records (pdb output)")
        return
    from .files import FileType

    s = _system(args)
    g = _group(s, args.sel)
    if args.whole:
        s.make_molecules_whole()
    if args.trans is not None:
        s.atoms_translate(np.asarray(args.trans, np.float32))
    if args.center:
        from .core.dimension import Dimension

        s.atoms_center(_group(s, args.center, "__cli_center"), Dimension.XYZ)
    if args.wrap:
        s.atoms_wrap()
    fmt = FileType.from_name(args.output)
    if fmt is FileType.GRO:
        s.group_write_gro(g, args.output, write_velocities=args.velocities)
    elif fmt is FileType.PDB:
        s.group_write_pdb(g, args.output, write_conect=args.conect)
    elif fmt is FileType.PQR:
        s.group_write_pqr(g, args.output)
    else:
        raise GroanError(
            f"unsupported structure output format '{args.output}' "
            "(gro/pdb/pqr)")
    print(f"wrote {args.output}")


@_tool("check", "print trajectory/structure info (gmx check)")
def _check(sp=None, args=None):
    if args is None:
        sp.add_argument("-s", "--structure", required=True)
        sp.add_argument("-f", "--trajectory", nargs="*", default=[])
        sp.add_argument("-n", "--index", default=None)
        return
    s = _system(args)
    box = s.get_box()
    print(f"structure: {args.structure}")
    print(f"  atoms:    {s.get_n_atoms()}")
    print(f"  residues: {len(np.unique(np.asarray(s.topology.resnum)))}")
    if box is not None and not box.is_zero():
        lx, ly, lz = (float(v) for v in box.lengths())
        print(f"  box:      {lx:.5g} x {ly:.5g} x {lz:.5g} nm"
              + ("" if box.is_orthogonal() else " (triclinic)"))
    for path in args.trajectory:
        reader = s.traj_iter(path)
        times = reader.times
        n = len(times)
        print(f"trajectory: {path}")
        print(f"  frames: {n}")
        if n:
            t0, t1 = float(times[0]), float(times[-1])
            print(f"  time:   {t0:g} .. {t1:g} ps")
        if n > 1:
            dts = np.diff(np.asarray(times, np.float64))
            if np.allclose(dts, dts[0]):
                print(f"  dt:     {dts[0]:g} ps")
            else:
                print(f"  dt:     non-uniform ({dts.min():g} .. "
                      f"{dts.max():g} ps)")


@_tool("distance", "COM-COM distance between two selections (gmx distance)")
def _distance(sp=None, args=None):
    if args is None:
        _common(sp, out="dist.xvg", windowed=True)
        sp.add_argument("--ref", required=True, help="second selection")
        sp.add_argument("--dim", default="xyz",
                        help="dimensions to use (subset of xyz)")
        return
    from .core.dimension import Dimension

    dim = Dimension.from_string(args.dim)

    def build(s, g, p):
        r = _group(s, args.ref, "__cli_ref")
        p.add_distance(g, r, dim=dim, name="d")
    _, _, out, _ = _pipe_run(args, build)
    _xvg(args, [out["times"], out["d"]], title="COM distance",
         xlabel="time (ps)", ylabel="distance (nm)", legends=["d"])


@_tool("angle", "angles/dihedrals over sites from a selection (gmx angle)")
def _angle(sp=None, args=None):
    if args is None:
        _common(sp, out="angle.xvg", windowed=True)
        sp.add_argument("--type", default="angle", dest="atype",
                        choices=["angle", "dihedral"])
        sp.add_argument("--all", action="store_true",
                        help="write every site (default: per-frame mean)")
        return
    width = 3 if args.atype == "angle" else 4

    def build(s, g, p):
        idx = np.asarray(s.group_indices(g))
        if len(idx) == 0 or len(idx) % width:
            raise GroanError(
                f"selection yields {len(idx)} atoms — {args.atype}s need "
                f"consecutive groups of {width} (gmx angle convention)")
        sites = idx.reshape(-1, width)
        if args.atype == "angle":
            p.add_angles(sites, name="a")
        else:
            p.add_dihedrals(sites, name="a")
        return sites.shape[0]
    _, _, out, n_sites = _pipe_run(args, build)
    a = np.asarray(out["a"], np.float64).reshape(len(out["times"]), n_sites)
    if args.all:
        cols = [out["times"]] + [a[:, k] for k in range(n_sites)]
        legends = [f"site{k}" for k in range(n_sites)]
    else:
        cols = [out["times"], a.mean(1)]
        legends = ["mean"]
    _xvg(args, cols, title=args.atype, xlabel="time (ps)",
         ylabel=f"{args.atype} (deg)", legends=legends)


@_tool("traj", "COM coordinates of a selection over time (gmx traj -com)")
def _trajtool(sp=None, args=None):
    if args is None:
        _common(sp, out="comx.xvg", windowed=True)
        sp.add_argument("--nomass", action="store_true",
                        help="geometric center instead of COM")
        return
    _, _, out, _ = _pipe_run(
        args, lambda s, g, p: (p.add_center(g, name="c") if args.nomass
                               else p.add_com(g, name="c")))
    c = np.asarray(out["c"], np.float64)
    _xvg(args, [out["times"], c[:, 0], c[:, 1], c[:, 2]],
         title="Center of mass", xlabel="time (ps)", ylabel="COM (nm)",
         legends=["x", "y", "z"])


@_tool("analyze", "statistics/ACF/error estimate of .xvg data (gmx analyze)")
def _analyze(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--file", required=True, help=".xvg input")
        sp.add_argument("--ac", default=None,
                        help="write normalized autocorrelations here (.xvg)")
        sp.add_argument("--nblocks", type=int, default=5,
                        help="blocks for the error estimate (gmx -ee style)")
        return
    from .io.xvg import read_xvg, write_xvg

    data = read_xvg(args.file)
    if data.ndim != 2 or data.shape[1] < 2:
        raise GroanError(f"'{args.file}' has no data columns")
    x, ys = data[:, 0], data[:, 1:]
    n = ys.shape[0]
    print(f"{n} points, {ys.shape[1]} data set(s)")
    for j in range(ys.shape[1]):
        y = ys[:, j]
        mean, std = y.mean(), y.std(ddof=1) if n > 1 else 0.0
        # block-averaged standard error (the classic Flyvbjerg-Petersen
        # estimate at a fixed block count, what gmx analyze -ee bounds)
        nb = max(2, min(args.nblocks, n))
        blocks = np.array([b.mean() for b in np.array_split(y, nb)])
        err = blocks.std(ddof=1) / np.sqrt(nb) if nb > 1 else 0.0
        print(f"set {j}: mean {mean:.8g}  std {std:.8g}  "
              f"error est. {err:.3g}  min {y.min():.8g}  max {y.max():.8g}")
    if args.ac:
        nlag = n // 2 if n >= 4 else n
        acs = []
        for j in range(ys.shape[1]):
            d = ys[:, j] - ys[:, j].mean()
            denom = float(d @ d)
            if denom == 0.0:
                acs.append(np.ones(nlag))
                continue
            full = np.correlate(d, d, mode="full")[n - 1:n - 1 + nlag]
            acs.append(full / denom)
        lags = x[:nlag] - x[0]
        write_xvg(args.ac, [lags] + acs, title="Autocorrelation",
                  xlabel="lag", ylabel="C(t)",
                  legends=[f"s{j}" for j in range(len(acs))])
        print(f"wrote {args.ac}")


@_tool("bar", "Bennett acceptance ratio free energy (gmx bar)")
def _bar(sp=None, args=None):
    if args is None:
        sp.add_argument("-F", "--forward", required=True, nargs="+",
                        help=".xvg files of forward work samples "
                        "(one per lambda interval)")
        sp.add_argument("-R", "--reverse", required=True, nargs="+",
                        help=".xvg files of reverse work samples")
        sp.add_argument("--temp", type=float, default=300.0)
        sp.add_argument("--col", type=int, default=1,
                        help="data column holding the work (kJ/mol)")
        sp.add_argument("-o", "--output", default="bar.xvg")
        return
    from . import models
    from .io.xvg import read_xvg, write_xvg

    if len(args.forward) != len(args.reverse):
        raise GroanError("need one --reverse file per --forward file")

    def _work(path):
        data = read_xvg(path)
        if data.ndim != 2 or data.shape[1] <= args.col:
            raise GroanError(f"'{path}' has no column {args.col}")
        return data[:, args.col]

    out = models.bar_intervals(
        [(_work(f), _work(r))
         for f, r in zip(args.forward, args.reverse)],
        temperature=args.temp)
    iv = np.arange(len(args.forward), dtype=np.float64)
    write_xvg(args.output, [iv, out["delta_f"], out["error"]],
              title="BAR free energy", xlabel="interval",
              ylabel="DeltaF (kJ/mol)", legends=["DeltaF", "error"])
    print(f"wrote {args.output}")
    for i, (df, err) in enumerate(zip(out["delta_f"], out["error"])):
        print(f"interval {i}: DeltaF {df:+.4f} +- {err:.4f} kJ/mol")
    print(f"total: {out['total']:+.4f} +- {out['total_error']:.4f} kJ/mol")


@_tool("bundle", "helix-bundle axis length/dist/tilt (gmx bundle)")
def _bundle(sp=None, args=None):
    if args is None:
        _common(sp, out="bundle.xvg")
        sp.add_argument("--tops", required=True,
                        help="top-end group/query (split into --na parts)")
        sp.add_argument("--bottoms", required=True,
                        help="bottom-end group/query")
        sp.add_argument("--na", type=int, required=True,
                        help="number of axes")
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        sp.add_argument("--cog", action="store_true",
                        help="geometric centers instead of mass-weighted")
        return
    from . import models

    s = _system(args)
    out = models.bundle(s, _traj(args), args.tops, args.bottoms,
                        n_axes=args.na, axis=args.axis,
                        mass_weighted=not args.cog,
                        batch_size=args.batch_size)
    t = np.arange(out["length"].shape[0], dtype=np.float64)
    cols = [t]
    legends = []
    for key in ("length", "distance", "zshift", "tilt", "tiltr", "tiltl"):
        for a in range(out[key].shape[1]):
            cols.append(out[key][:, a])
            legends.append(f"{key}{a}")
    _xvg(args, cols, title="Bundle axes", xlabel="frame",
         ylabel="nm / deg", legends=legends)
    print(f"mean length {out['length'].mean():.4f} nm, tilt "
          f"{out['tilt'].mean():.2f} deg, distance "
          f"{out['distance'].mean():.4f} nm")


@_tool("dyecoupl", "FRET dye-pair distance and kappa^2 (gmx dyecoupl)")
def _dyecoupl(sp=None, args=None):
    if args is None:
        _common(sp, out="dyecoupl.xvg")
        sp.add_argument("--donor", required=True,
                        help="2-atom donor dipole selection")
        sp.add_argument("--acceptor", required=True,
                        help="2-atom acceptor dipole selection")
        sp.add_argument("--r0", type=float, default=None,
                        help="isotropic Foerster radius (nm) for E")
        return
    from . import models

    s = _system(args)
    out = models.dyecoupl(s, _traj(args), args.donor, args.acceptor,
                          r0=args.r0, batch_size=args.batch_size)
    t = np.arange(out["r"].shape[0], dtype=np.float64)
    cols = [t, out["r"], out["kappa2"]]
    legends = ["R", "kappa2"]
    if "efficiency" in out:
        cols.append(out["efficiency"])
        legends.append("E")
    _xvg(args, cols, title="Dye coupling", xlabel="frame",
         ylabel="R (nm) / kappa^2", legends=legends)
    msg = (f"mean R {out['r'].mean():.4f} nm, <kappa^2> "
           f"{out['kappa2'].mean():.4f}")
    if "efficiency" in out:
        msg += f", <E> {out['efficiency'].mean():.4f}"
    print(msg)


@_tool("gangle", "angles of selection vectors/planes (gmx gangle)")
def _gangle(sp=None, args=None):
    if args is None:
        _common(sp, out="gangle.xvg")
        sp.add_argument("--g1", default="vector",
                        choices=["vector", "plane"],
                        help="site type from --sel (pairs / triples)")
        sp.add_argument("--g2", default="z",
                        choices=["x", "y", "z", "t0", "vector", "plane"],
                        help="reference: box axis, first frame, or "
                        "--ref sites")
        sp.add_argument("--ref", default=None,
                        help="second selection for --g2 vector/plane")
        sp.add_argument("--all", action="store_true",
                        help="write every site (default: per-frame mean)")
        return
    from . import models

    s = _system(args)
    out = models.gangle(s, _traj(args), args.sel, g1=args.g1, g2=args.g2,
                        group2=args.ref, batch_size=args.batch_size)
    t = np.arange(out["mean"].shape[0], dtype=np.float64)
    if args.all:
        cols = [t] + [out["angles"][:, j]
                      for j in range(out["angles"].shape[1])]
        legends = [f"site{j}" for j in range(out["angles"].shape[1])]
    else:
        cols, legends = [t, out["mean"]], ["mean"]
    _xvg(args, cols, title="Angles", xlabel="frame",
         ylabel="angle (deg)", legends=legends)
    print(f"mean angle {out['mean'].mean():.3f} deg over "
          f"{out['angles'].shape[1]} sites")


@_tool("pairdist", "per-frame unit distance matrices (gmx pairdist)")
def _pairdist(sp=None, args=None):
    if args is None:
        _common(sp, out="pairdist.xvg")
        sp.add_argument("--ref", required=True, help="second selection")
        sp.add_argument("--split", default="res",
                        choices=["res", "atom", "group"])
        sp.add_argument("--mode", default="min", choices=["min", "com"])
        return
    from . import models

    s = _system(args)
    out = models.pairdist(s, _traj(args), args.sel, args.ref,
                          split=args.split, mode=args.mode,
                          batch_size=args.batch_size)
    d = out["dist"]
    f, k1, k2 = d.shape
    t = np.arange(f, dtype=np.float64)
    cols = [t] + [d[:, i, j] for i in range(k1) for j in range(k2)]
    legends = [f"{i}-{j}" for i in range(k1) for j in range(k2)]
    _xvg(args, cols, title="Pair distances", xlabel="frame",
         ylabel="distance (nm)", legends=legends)
    print(f"{k1}x{k2} unit pairs, grand mean {d.mean():.4f} nm, "
          f"min {d.min():.4f} nm")


@_tool("chi", "side-chain chi dihedrals and rotamers (gmx chi)")
def _chi(sp=None, args=None):
    if args is None:
        _common(sp, out="chi.xvg")
        sp.add_argument("--max-chi", type=int, default=2,
                        help="highest chi order to compute (1-4)")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.chi(s, _traj(args), g, max_chi=args.max_chi,
                     batch_size=args.batch_size)
    t = np.arange(out["chi1"].shape[0], dtype=np.float64)
    cols, legends = [t], []
    for k in range(1, args.max_chi + 1):
        key = f"chi{k}"
        if key not in out:
            continue
        for j, rid in enumerate(out[f"{key}_resids"]):
            cols.append(out[key][:, j])
            legends.append(f"{key}-{out[f'{key}_resnames'][j]}{rid}")
    _xvg(args, cols, title="Chi dihedrals", xlabel="frame",
         ylabel="chi (deg)", legends=legends)
    rot = out["rotamers"]
    for j, rid in enumerate(out["chi1_resids"]):
        print(f"{out['chi1_resnames'][j]}{rid}: g+ {rot['g+'][j]:.3f}  "
              f"t {rot['t'][j]:.3f}  g- {rot['g-'][j]:.3f}")


@_tool("select", "per-frame dynamic selection sizes/occupancy (gmx select)")
def _select(sp=None, args=None):
    if args is None:
        _common(sp, out="size.xvg")
        sp.add_argument("--within", type=float, default=None,
                        help="select atoms within R nm of --of (dynamic)")
        sp.add_argument("--of", default=None,
                        help="reference selection for --within")
        sp.add_argument("--sphere", default=None,
                        help="x,y,z,r static sphere criterion (nm)")
        sp.add_argument("--whole-res", action="store_true",
                        help="extend membership to whole residues")
        sp.add_argument("--on", default=None,
                        help="write per-frame index groups to this .ndx")
        sp.add_argument("--oc", default=None,
                        help="write per-atom occupancy .xvg")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    shape = None
    if args.sphere:
        from .core.shapes import Sphere

        x, y, z, r = (float(v) for v in args.sphere.split(","))
        shape = Sphere((x, y, z), r)
    out = models.select_dynamic(
        s, _traj(args), g, within=args.within, of=args.of, shape=shape,
        whole_res=args.whole_res, batch_size=args.batch_size)
    f = np.arange(len(out["sizes"]))
    _xvg(args, [f, out["sizes"]], title="Selection size", xlabel="frame",
         ylabel="atoms", legends=["size"])
    if args.oc:
        from .io.xvg import write_xvg

        write_xvg(args.oc, [out["indices"] + 1, out["occupancy"]],
                  title="Occupancy", xlabel="atom", ylabel="fraction",
                  legends=["occupancy"])
        print(f"wrote {args.oc}")
    if args.on:
        with open(args.on, "w") as fh:
            for i, row in enumerate(out["masks"]):
                sel = out["indices"][row] + 1
                fh.write(f"[ sel_f{i} ]\n")
                for j in range(0, len(sel), 15):
                    fh.write(" ".join(str(v) for v in sel[j:j + 15]) + "\n")
        print(f"wrote {args.on}")
    print(f"mean size {out['sizes'].mean():.2f} atoms over "
          f"{len(out['sizes'])} frames")



@_tool("saltbr", "salt-bridge COM distances per charged pair (gmx saltbr)")
def _saltbr(sp=None, args=None):
    if args is None:
        _common(sp, out="saltbr.xvg")
        sp.add_argument("--min-charge", type=float, default=0.5,
                        help="|net residue charge| threshold")
        sp.add_argument("-t", "--trunc", type=float, default=None,
                        help="keep only pairs that come closer than this")
        return
    from . import models

    s = _system(args)
    out = models.saltbr(s, _traj(args), args.sel,
                        min_charge=args.min_charge, trunc=args.trunc,
                        batch_size=args.batch_size)
    d = out["dist"]
    t = np.arange(d.shape[0], dtype=np.float64)
    legends = [f"{out['labels'][i]}:{out['labels'][j]} ({k})"
               for (i, j), k in zip(out["pairs"], out["kinds"])]
    _xvg(args, [t] + [d[:, p] for p in range(d.shape[1])],
         title="Salt bridges", xlabel="frame", ylabel="distance (nm)",
         legends=legends)
    print(f"{len(legends)} charged pairs "
          f"({(out['kinds'] == '+-').sum()} opposite-sign), "
          f"closest approach {d.min():.4f} nm")


@_tool("spol", "solvent dipole orientation vs solute distance (gmx spol)")
def _spol(sp=None, args=None):
    if args is None:
        _common(sp, out="spol.xvg")
        sp.add_argument("--ref", required=True,
                        help="solute selection (COM reference)")
        sp.add_argument("--rmax", type=float, default=1.0)
        sp.add_argument("--bins", type=int, default=50)
        return
    from . import models

    s = _system(args)
    out = models.spol(s, _traj(args), args.ref, args.sel,
                      rmax=args.rmax, bins=args.bins,
                      batch_size=args.batch_size)
    _xvg(args, [out["r_bins"], out["mean_cos_r"], out["counts"]],
         title="Solvent polarization", xlabel="r (nm)",
         ylabel="<cos theta>", legends=["<cos theta>", "count"])
    print(f"{out['n_selected']:.0f} molecule-frames in range, "
          f"mean cos {out['mean_cos']:.4f}")


@_tool("trjorder", "order solvent by distance to a group (gmx trjorder)")
def _trjorder(sp=None, args=None):
    if args is None:
        _common(sp, out="ordered.xtc")
        sp.add_argument("--ref", required=True, help="reference selection")
        sp.add_argument("--mode", default="atom",
                        choices=["atom", "min", "com"])
        sp.add_argument("--da", type=int, default=0,
                        help="distance atom within each molecule")
        sp.add_argument("--shell", type=float, default=None,
                        help="count molecules within this radius")
        sp.add_argument("--nshell-out", default=None,
                        help="write the shell-count series to this .xvg")
        sp.add_argument("--no-write", action="store_true",
                        help="skip the reordered trajectory output")
        sp.add_argument("--outfmt", default=None)
        return
    from . import models

    s = _system(args)
    out = models.trjorder(s, _traj(args), args.ref, args.sel,
                          mode=args.mode, da=args.da, shell=args.shell,
                          output=None if args.no_write else args.output,
                          outfmt=args.outfmt, batch_size=args.batch_size)
    if not args.no_write:
        print(f"wrote {args.output} ({out['dist'].shape[0]} frames, "
              f"{out['dist'].shape[1]} molecules reordered)")
    if args.shell is not None and args.nshell_out:
        from .io.xvg import write_xvg

        t = np.arange(out["nshell"].shape[0], dtype=np.float64)
        write_xvg(args.nshell_out, [t, out["nshell"].astype(np.float64)],
                  title="Molecules in shell", xlabel="frame",
                  ylabel="count", legends=[f"r < {args.shell} nm"])
        print(f"wrote {args.nshell_out}")
    print(f"closest molecule {out['dist'].min():.4f} nm")


@_tool("hydorder", "tetrahedrality order parameters (gmx hydorder)")
def _hydorder(sp=None, args=None):
    if args is None:
        _common(sp, out="hydorder.xvg")
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        sp.add_argument("--slabs", type=int, default=0,
                        help="fractional slabs along the axis (0 = none)")
        return
    from . import models

    s = _system(args)
    sel = args.sel if args.sel != "all" else "name OW"
    out = models.hydorder(s, _traj(args), sel, axis=args.axis,
                          slabs=args.slabs, batch_size=args.batch_size)
    if args.slabs:
        _xvg(args, [np.arange(args.slabs, dtype=np.float64),
                    out["slab_sg"], out["slab_sk"]],
             title="Tetrahedrality profile", xlabel="slab",
             ylabel="order parameter", legends=["S_g", "S_k"])
    else:
        t = np.arange(out["mean_sg"].shape[0], dtype=np.float64)
        _xvg(args, [t, out["mean_sg"], out["mean_sk"]],
             title="Tetrahedrality", xlabel="frame",
             ylabel="order parameter", legends=["S_g", "S_k"])
    print(f"mean S_g {out['mean_sg'].mean():.4f}, "
          f"S_k {out['mean_sk'].mean():.4f}")


@_tool("rotacf", "rotational ACF of axis vectors (gmx rotacf)")
def _rotacf(sp=None, args=None):
    if args is None:
        _common(sp, out="rotacf.xvg", windowed=True)
        sp.add_argument("-P", "--order", type=int, default=2,
                        choices=[1, 2], help="Legendre order")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    idx = np.asarray(s.group_indices(g))
    if len(idx) == 0 or len(idx) % 2:
        raise GroanError(
            f"selection yields {len(idx)} atoms — vectors need "
            "consecutive PAIRS (gmx angle-style index convention)")
    lags, curve = models.rotacf(s, _traj(args), idx.reshape(-1, 2),
                                order=args.order,
                                batch_size=args.batch_size)
    _xvg(args, [lags, curve], title="Rotational ACF",
         xlabel="time (ps)", ylabel=f"C_{args.order}(t)",
         legends=[f"P{args.order}"])
    print(f"C(0) = {curve[0]:.4f}, C(max lag) = {curve[-1]:.4f}")


@_tool("mdmat", "residue smallest-distance matrix (gmx mdmat)")
def _mdmat(sp=None, args=None):
    if args is None:
        _common(sp, out="mdmat.dat")
        sp.add_argument("--per-frame", action="store_true",
                        help="write one matrix block per frame")
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.mdmat(s, _traj(args), g, per_frame=args.per_frame,
                       batch_size=args.batch_size)
    m = out["mean" if not args.per_frame else "frames"]
    with open(args.output, "w") as fh:
        fh.write("# residue smallest-distance matrix (nm)\n# residues: "
                 + " ".join(f"{n}{r}" for n, r in
                            zip(out["resnames"], out["resids"])) + "\n")
        for block in (m[None] if not args.per_frame else m):
            np.savetxt(fh, block, fmt="%.4f")
            fh.write("\n")
    print(f"wrote {args.output} ({m.shape[-1]} residues, "
          f"mean distance {m.mean():.4f} nm)")


@_tool("leaflets", "membrane leaflet assignment + thickness")
def _leaflets(sp=None, args=None):
    if args is None:
        _common(sp, out="leaflets.xvg")
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        return
    from . import models

    s = _system(args)
    out = models.leaflets(s, _traj(args), args.sel, axis=args.axis,
                          batch_size=args.batch_size)
    t = np.arange(out["thickness"].shape[0], dtype=np.float64)
    upper = (out["leaflet"] > 0).sum(axis=1).astype(np.float64)
    lower = (out["leaflet"] < 0).sum(axis=1).astype(np.float64)
    _xvg(args, [t, out["thickness"], upper, lower],
         title="Leaflets", xlabel="frame", ylabel="thickness (nm)",
         legends=["thickness", "upper", "lower"])
    print(f"mean thickness {out['thickness'].mean():.4f} nm, "
          f"{out['leaflet'].shape[1]} heads")



@_tool("dielectric", "frequency-dependent dielectric (gmx dielectric)")
def _dielectric(sp=None, args=None):
    if args is None:
        _common(sp, out="epsw.xvg")
        sp.add_argument("--temperature", type=float, default=300.0)
        sp.add_argument("--nfreq", type=int, default=120)
        return
    from . import models

    s = _system(args)
    g = _group(s, args.sel)
    out = models.dielectric_spectrum(s, _traj(args), g,
                                     temperature=args.temperature,
                                     n_freq=args.nfreq,
                                     batch_size=args.batch_size)
    _xvg(args, [out["omega"], out["eps_real"], out["eps_imag"]],
         title="Dielectric spectrum", xlabel="omega (rad/ps)",
         ylabel="epsilon", legends=["eps'", "eps''"])
    print(f"eps_static {out['eps_static']:.6g}, "
          f"corr time {out['corr_time']:.4g} ps")


@_tool("densorder", "density-profile interface positions (gmx densorder)")
def _densorder(sp=None, args=None):
    if args is None:
        _common(sp, out="interfaces.xvg")
        sp.add_argument("--axis", default="z", choices=["x", "y", "z"])
        sp.add_argument("--bins", type=int, default=100)
        sp.add_argument("--mode", default="mass",
                        choices=["number", "mass", "charge"])
        sp.add_argument("--threshold", type=float, default=0.5,
                        help="interface level as a fraction of the "
                             "per-frame profile maximum")
        return
    from . import models

    s = _system(args)
    out = models.densorder(s, _traj(args), args.sel, axis=args.axis,
                           bins=args.bins, mode=args.mode,
                           threshold=args.threshold,
                           batch_size=args.batch_size)
    t = np.arange(out["lower"].shape[0], dtype=np.float64)
    _xvg(args, [t, out["lower"], out["upper"], out["thickness"]],
         title="Interfaces", xlabel="frame", ylabel="position (nm)",
         legends=["lower", "upper", "thickness"])
    print(f"mean thickness {np.nanmean(out['thickness']):.4f} nm, "
          f"sigma lower/upper {out['lower_sigma']:.4f}/"
          f"{out['upper_sigma']:.4f} nm")



@_tool("morph", "interpolate between two conformations (gmx morph)")
def _morph(sp=None, args=None):
    if args is None:
        _common(sp, out="morph.xtc", traj=False)
        sp.add_argument("--f2", required=True,
                        help="second conformation (structure file)")
        sp.add_argument("--ninterm", type=int, default=30)
        sp.add_argument("--first", type=float, default=0.0)
        sp.add_argument("--last", type=float, default=1.0)
        sp.add_argument("--nofit", action="store_true",
                        help="skip the least-squares fit of B onto A")
        sp.add_argument("--rmsd-out", default=None,
                        help="write per-frame RMSD to both endpoints")
        sp.add_argument("--outfmt", default=None)
        return
    from . import models
    from .system import System

    s = _system(args)
    b = System.from_file(args.f2)
    # gro/pdb structures carry no masses: guess them for the fit
    for sys_ in (s, b):
        if not np.asarray(sys_.topology.has_mass).all():
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sys_.guess_elements()
                sys_.guess_properties()
    out = models.morph(s, b, n=args.ninterm, first=args.first,
                       last=args.last, fit=not args.nofit,
                       group=args.sel, output=args.output,
                       outfmt=args.outfmt)
    print(f"wrote {args.output} ({args.ninterm} frames, "
          f"endpoint RMSD {out['rmsd_b'][0]:.4f} nm)")
    if args.rmsd_out:
        from .io.xvg import write_xvg

        write_xvg(args.rmsd_out,
                  [out["lambdas"], out["rmsd_a"], out["rmsd_b"]],
                  title="Morph RMSD", xlabel="lambda",
                  ylabel="RMSD (nm)", legends=["to A", "to B"])
        print(f"wrote {args.rmsd_out}")


@_tool("lie", "linear interaction energy estimate (gmx lie)")
def _lie(sp=None, args=None):
    if args is None:
        sp.add_argument("-f", "--energies", required=True,
                        help=".xvg with E_LJ and E_qq series")
        sp.add_argument("--lj-col", type=int, default=1,
                        help="E_LJ column index (time is column 0)")
        sp.add_argument("--qq-col", type=int, default=2)
        sp.add_argument("--clj", type=float, default=0.181)
        sp.add_argument("--cqq", type=float, default=0.5)
        sp.add_argument("--elj0", type=float, default=0.0)
        sp.add_argument("--eqq0", type=float, default=0.0)
        sp.add_argument("-o", "--output", default="lie.xvg")
        return
    from . import models
    from .io.xvg import read_xvg, write_xvg

    d = read_xvg(args.energies)
    out = models.lie(d[:, args.lj_col], d[:, args.qq_col],
                     clj=args.clj, cqq=args.cqq,
                     elj0=args.elj0, eqq0=args.eqq0)
    write_xvg(args.output, [d[:, 0], out["dg"]], title="LIE",
              xlabel="time (ps)", ylabel="dG (kJ/mol)", legends=["dG"])
    print(f"DGbind = {out['dg_mean']:.4f} +/- {out['dg_std']:.4f} kJ/mol "
          f"(<E_LJ> {out['e_lj_mean']:.3f}, <E_qq> {out['e_qq_mean']:.3f})")


@_tool("anaeig", "PCA eigenvector analysis: overlaps, cosine content, "
       "mode trajectories (gmx anaeig)")
def _anaeig(sp=None, args=None):
    if args is None:
        _common(sp, out="proj.xvg")
        sp.add_argument("--f2", default=None, nargs="+",
                        help="second trajectory: compute subspace/"
                        "covariance overlap between the two PCAs "
                        "(gmx anaeig -over)")
        sp.add_argument("--nover", type=int, default=10,
                        help="modes for the overlap (default 10)")
        sp.add_argument("--cc", type=int, default=0,
                        help="print cosine content of the first N PCs "
                        "(gmx analyze -cc)")
        sp.add_argument("--nmtraj", default=None,
                        help="write an oscillation trajectory along "
                        "--mode here (gmx nmtraj)")
        sp.add_argument("--mode", type=int, default=1,
                        help="1-based mode for --nmtraj")
        sp.add_argument("--amplitude", type=float, default=None,
                        help="oscillation amplitude in projection units "
                        "(default: quasi-harmonic sqrt(2 lambda))")
        sp.add_argument("--nframes", type=int, default=30)
        sp.add_argument("--ncomp", type=int, default=None)
        return
    from . import models
    from .io.xvg import write_xvg

    s = _system(args)
    g = _group(s, args.sel)
    a = models.pca(s, _traj(args), g, n_components=args.ncomp,
                   batch_size=args.batch_size)
    pr = a["projections"]
    t = np.arange(pr.shape[0], dtype=np.float64)
    ncols = min(2, pr.shape[1])
    write_xvg(args.output, [t] + [pr[:, i] for i in range(ncols)],
              title="PC projections", xlabel="frame",
              ylabel="proj (amu^1/2 nm)",
              legends=[f"PC{i + 1}" for i in range(ncols)])
    print(f"wrote {args.output}")
    if args.cc:
        cc = models.cosine_content(pr, n_modes=args.cc)
        for i, c in enumerate(cc):
            print(f"cosine content PC{i + 1}: {c:.4f}")
    if args.f2:
        f2 = args.f2[0] if len(args.f2) == 1 else list(args.f2)
        b = models.pca(s, f2, g, n_components=args.ncomp,
                       batch_size=args.batch_size)
        ov = models.subspace_overlap(a, b, n=min(
            args.nover, a["eigenvalues"].shape[0],
            b["eigenvalues"].shape[0]))
        print(f"subspace overlap ({ov['n']} modes): "
              f"{ov['subspace_overlap']:.4f} (RMSIP {ov['rmsip']:.4f})")
        print(f"covariance overlap: {ov['covariance_overlap']:.4f}")
    if args.nmtraj:
        mt = models.mode_traj(s, a, g, mode=args.mode,
                              amplitude=args.amplitude, n=args.nframes,
                              output=args.nmtraj)
        print(f"wrote {args.nmtraj} ({args.nframes} frames along "
              f"PC{args.mode}, amplitude {mt['amplitude']:.4g})")


@_tool("dump", "print file contents as text (gmx dump)")
def _dump(sp=None, args=None):
    if args is None:
        sp.add_argument("-s", "--structure", default=None,
                        help="structure/topology file (tpr/gro/pdb/pqr)")
        sp.add_argument("-f", "--trajectory", default=None, nargs="+",
                        help="trajectory file(s); requires -s")
        sp.add_argument("--max-atoms", type=int, default=10,
                        help="atoms to print per section (default 10)")
        sp.add_argument("--max-frames", type=int, default=5,
                        help="frames to print (default 5)")
        return
    if not args.structure:
        raise GroanError("dump needs -s (and optionally -f)")
    from .system import System

    s = System.from_file(args.structure)
    topo = s.topology
    n = s.get_n_atoms()
    print(f"{args.structure}:")
    print(f"  natoms = {n}")
    box = s.get_box()
    if box is not None:
        m = np.asarray(box.to_matrix(), np.float64)
        print(f"  box (nm) = [{m[0, 0]:.5f} {m[1, 1]:.5f} {m[2, 2]:.5f}]"
              + ("" if box.is_orthogonal() else
                 f" off-diagonal yx={m[1, 0]:.5f} zx={m[2, 0]:.5f} "
                 f"zy={m[2, 1]:.5f}"))
    nb = (sum(len(b) for b in topo.bonded) // 2
          if topo.has_bonds() else 0)
    print(f"  bonds = {nb}")
    if getattr(s, "groups", None):
        names = ", ".join(sorted(s.groups))
        print(f"  groups = {names}")
    k = min(int(args.max_atoms), n)
    for i in range(k):
        parts = [f"  atom {i}: {topo.resnum[i]} {topo.resname.get(i)} "
                 f"{topo.atomname.get(i)} (#{topo.atomnum[i]})"]
        if topo.has_mass[i]:
            parts.append(f"m={float(topo.mass[i]):.4f}")
        if topo.has_charge[i]:
            parts.append(f"q={float(topo.charge[i]):+.4f}")
        pos = s.positions[i]
        parts.append(f"x=({pos[0]:.4f} {pos[1]:.4f} {pos[2]:.4f})")
        print(" ".join(parts))
    if n > k:
        print(f"  ... {n - k} more atoms")
    if args.trajectory:
        files = args.trajectory
        reader = s.traj_cat_iter(list(files))
        for fi, _ in enumerate(reader):
            if fi >= int(args.max_frames):
                print("  ...")
                break
            b = s.get_box()
            lens = (np.diag(np.asarray(b.to_matrix()))
                    if b is not None else np.zeros(3))
            print(f"  frame {fi}: t={s.get_time():g} ps "
                  f"box=({lens[0]:.4f} {lens[1]:.4f} {lens[2]:.4f})")
            for i in range(min(int(args.max_atoms), n)):
                pos = s.positions[i]
                print(f"    x[{i}] = ({pos[0]:.5f} {pos[1]:.5f} "
                      f"{pos[2]:.5f})")


@_tool("sigeps", "convert c6/c12 <-> sigma/epsilon + LJ curve "
       "(gmx sigeps)")
def _sigeps(sp=None, args=None):
    if args is None:
        sp.add_argument("--c6", type=float, default=None,
                        help="C6 (kJ/mol nm^6)")
        sp.add_argument("--c12", type=float, default=None,
                        help="C12 (kJ/mol nm^12)")
        sp.add_argument("--sigma", type=float, default=None, help="nm")
        sp.add_argument("--eps", type=float, default=None, help="kJ/mol")
        sp.add_argument("-o", "--output", default=None,
                        help="write V(r) and F(r) here (.xvg)")
        sp.add_argument("--rmax", type=float, default=1.5)
        sp.add_argument("--bins", type=int, default=300)
        return
    if args.c6 is not None and args.c12 is not None:
        c6, c12 = args.c6, args.c12
        if c6 <= 0 or c12 <= 0:
            raise GroanError("c6 and c12 must be positive")
        sigma = (c12 / c6) ** (1.0 / 6.0)
        eps = c6 * c6 / (4.0 * c12)
    elif args.sigma is not None and args.eps is not None:
        sigma, eps = args.sigma, args.eps
        if sigma <= 0 or eps <= 0:
            raise GroanError("sigma and eps must be positive")
        c6 = 4.0 * eps * sigma ** 6
        c12 = 4.0 * eps * sigma ** 12
    else:
        raise GroanError("pass --c6 AND --c12, or --sigma AND --eps")
    rmin = sigma * 2.0 ** (1.0 / 6.0)
    print(f"c6 = {c6:.6g} kJ/mol nm^6, c12 = {c12:.6g} kJ/mol nm^12")
    print(f"sigma = {sigma:.6g} nm, epsilon = {eps:.6g} kJ/mol, "
          f"rmin = {rmin:.6g} nm")
    if args.output:
        from .io.xvg import write_xvg

        r = np.linspace(args.rmax / args.bins, args.rmax, args.bins)
        v = c12 / r ** 12 - c6 / r ** 6
        f = 12 * c12 / r ** 13 - 6 * c6 / r ** 7
        write_xvg(args.output, [r, v, f], title="Lennard-Jones",
                  xlabel="r (nm)", ylabel="V (kJ/mol), F (kJ/mol nm)",
                  legends=["V", "F"])
        print(f"wrote {args.output}")


@_tool("genrestr", "generate position-restraint topology entries "
       "(gmx genrestr)")
def _genrestr(sp=None, args=None):
    if args is None:
        sp.add_argument("-s", "--structure", required=True)
        sp.add_argument("-n", "--index", default=None)
        sp.add_argument("--sel", default="all",
                        help="atoms to restrain (GSL or group name)")
        sp.add_argument("--fc", type=float, nargs=3,
                        default=[1000.0, 1000.0, 1000.0],
                        metavar=("FX", "FY", "FZ"),
                        help="force constants (kJ/mol nm^2)")
        sp.add_argument("-o", "--output", default="posre.itp")
        return
    s = _system(args)
    g = _group(s, args.sel)
    idx = np.asarray(s.group_indices(g))
    if idx.size == 0:
        raise GroanError(f"selection '{args.sel}' is empty")
    fx, fy, fz = args.fc
    with open(args.output, "w") as fh:
        fh.write("[ position_restraints ]\n")
        fh.write(";  i funct       fcx        fcy        fcz\n")
        for i in idx:
            # gmx genrestr numbers atoms 1-based within the molecule
            fh.write(f"{int(i) + 1:4d}    1 {fx:10g} {fy:10g} {fz:10g}\n")
    print(f"wrote {args.output} ({idx.size} restraints)")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="groan",
        description="JAX MD analysis tools (gmx-style CLI)")
    sub = p.add_subparsers(dest="tool", required=True, metavar="<tool>")
    for name, (fn, help_) in sorted(TOOLS.items()):
        sp = sub.add_parser(name, help=help_)
        fn(sp)                       # register options
        sp.set_defaults(_run=fn)
    args = p.parse_args(argv)
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        args._run(args=args)
    except GroanError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
