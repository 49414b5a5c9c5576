"""XML serialization of SlicedNonbondedForce (a copy of the JAX package's
``serialization/xml_proxy.py``).

Round-trips the exact field set of the reference's serialization proxy
(serialization/src/SlicedNonbondedForceProxy.cpp:24-162),
using the same element and attribute names so that force definitions are
portable between the two implementations, and version-gated identically.
"""

import xml.etree.ElementTree as ET

from ..models.force import OpenMMException, SlicedNonbondedForce


class XmlSerializer:
    @staticmethod
    def serialize(force: SlicedNonbondedForce) -> str:
        if not isinstance(force, SlicedNonbondedForce):
            raise OpenMMException("XmlSerializer: unsupported object type")
        node = ET.Element("SlicedNonbondedForce")
        node.set("version", "1")
        node.set("numSubsets", str(force.getNumSubsets()))
        node.set("forceGroup", str(force.getForceGroup()))
        node.set("name", force.getName())
        node.set("method", str(force.getNonbondedMethod()))
        node.set("cutoff", repr(force.getCutoffDistance()))
        node.set("useSwitchingFunction", str(int(force.getUseSwitchingFunction())))
        node.set("switchingDistance", repr(force.getSwitchingDistance()))
        node.set("ewaldTolerance", repr(force.getEwaldErrorTolerance()))
        node.set("rfDielectric", repr(force.getReactionFieldDielectric()))
        node.set("dispersionCorrection", str(int(force.getUseDispersionCorrection())))
        node.set("exceptionsUsePeriodic",
                 str(int(force.getExceptionsUsePeriodicBoundaryConditions())))
        node.set("includeDirectSpace", str(int(force.getIncludeDirectSpace())))
        alpha, nx, ny, nz = force.getPMEParameters()
        node.set("alpha", repr(alpha))
        node.set("nx", str(nx))
        node.set("ny", str(ny))
        node.set("nz", str(nz))
        alpha, nx, ny, nz = force.getLJPMEParameters()
        node.set("ljAlpha", repr(alpha))
        node.set("ljnx", str(nx))
        node.set("ljny", str(ny))
        node.set("ljnz", str(nz))
        node.set("recipForceGroup", str(force.getReciprocalSpaceForceGroup()))

        globals_node = ET.SubElement(node, "GlobalParameters")
        for i in range(force.getNumGlobalParameters()):
            p = ET.SubElement(globals_node, "Parameter")
            p.set("name", force.getGlobalParameterName(i))
            p.set("default", repr(force.getGlobalParameterDefaultValue(i)))
        particle_offsets = ET.SubElement(node, "ParticleOffsets")
        for i in range(force.getNumParticleParameterOffsets()):
            param, particle, q, sig, eps = force.getParticleParameterOffset(i)
            o = ET.SubElement(particle_offsets, "Offset")
            o.set("parameter", param)
            o.set("particle", str(particle))
            o.set("q", repr(q))
            o.set("sig", repr(sig))
            o.set("eps", repr(eps))
        exception_offsets = ET.SubElement(node, "ExceptionOffsets")
        for i in range(force.getNumExceptionParameterOffsets()):
            param, exception, q, sig, eps = force.getExceptionParameterOffset(i)
            o = ET.SubElement(exception_offsets, "Offset")
            o.set("parameter", param)
            o.set("exception", str(exception))
            o.set("q", repr(q))
            o.set("sig", repr(sig))
            o.set("eps", repr(eps))
        particles = ET.SubElement(node, "Particles")
        for i in range(force.getNumParticles()):
            q, sig, eps = force.getParticleParameters(i)
            p = ET.SubElement(particles, "Particle")
            p.set("q", repr(q))
            p.set("sig", repr(sig))
            p.set("eps", repr(eps))
        exceptions = ET.SubElement(node, "Exceptions")
        for i in range(force.getNumExceptions()):
            p1, p2, q, sig, eps = force.getExceptionParameters(i)
            e = ET.SubElement(exceptions, "Exception")
            e.set("p1", str(p1))
            e.set("p2", str(p2))
            e.set("q", repr(q))
            e.set("sig", repr(sig))
            e.set("eps", repr(eps))
        subsets = ET.SubElement(node, "Subsets")
        for i in range(force.getNumParticles()):
            subset = force.getParticleSubset(i)
            if subset != 0:
                s = ET.SubElement(subsets, "Subset")
                s.set("index", str(i))
                s.set("subset", str(subset))
        scaling = ET.SubElement(node, "scalingParameters")
        for i in range(force.getNumScalingParameters()):
            param, s1, s2, inc_c, inc_lj = force.getScalingParameter(i)
            s = ET.SubElement(scaling, "scalingParameter")
            s.set("parameter", param)
            s.set("subset1", str(s1))
            s.set("subset2", str(s2))
            s.set("includeCoulomb", str(int(inc_c)))
            s.set("includeLJ", str(int(inc_lj)))
        derivs = ET.SubElement(node, "energyParameterDerivatives")
        for i in range(force.getNumEnergyParameterDerivatives()):
            d = ET.SubElement(derivs, "energyParameterDerivative")
            d.set("parameter", force.getEnergyParameterDerivativeName(i))
        return ET.tostring(node, encoding="unicode")

    @staticmethod
    def deserialize(text: str) -> SlicedNonbondedForce:
        # property/section access mirrors the reference proxy exactly
        # (SlicedNonbondedForceProxy.cpp:103-162): required properties and
        # child nodes raise OpenMMException when absent; the documented
        # optional ones fall back to their defaults.
        def req(elem, attr, conv):
            val = elem.get(attr)
            if val is None:
                raise OpenMMException(
                    f"XmlSerializer: missing required property '{attr}'")
            try:
                return conv(val)
            except ValueError as exc:
                raise OpenMMException(
                    f"XmlSerializer: malformed property '{attr}'") from exc

        def opt(elem, attr, conv, default):
            val = elem.get(attr)
            if val is None:
                return default
            try:
                return conv(val)
            except ValueError as exc:
                raise OpenMMException(
                    f"XmlSerializer: malformed property '{attr}'") from exc

        def child(elem, name):
            c = elem.find(name)
            if c is None:
                raise OpenMMException(
                    f"XmlSerializer: missing child node '{name}'")
            return c

        intbool = lambda s: bool(int(s))  # noqa: E731
        try:
            node = ET.fromstring(text)
        except ET.ParseError as exc:
            raise OpenMMException(
                f"XmlSerializer: could not parse XML ({exc})") from exc
        if node.tag != "SlicedNonbondedForce":
            raise OpenMMException("XmlSerializer: unsupported object type")
        if req(node, "version", int) != 1:
            raise OpenMMException("Unsupported version number")
        force = SlicedNonbondedForce(req(node, "numSubsets", int))
        force.setForceGroup(opt(node, "forceGroup", int, 0))
        force.setName(node.get("name", force.getName()))
        force.setNonbondedMethod(req(node, "method", int))
        force.setCutoffDistance(req(node, "cutoff", float))
        force.setUseSwitchingFunction(opt(node, "useSwitchingFunction",
                                          intbool, False))
        force.setSwitchingDistance(opt(node, "switchingDistance", float, -1.0))
        force.setEwaldErrorTolerance(req(node, "ewaldTolerance", float))
        force.setReactionFieldDielectric(req(node, "rfDielectric", float))
        force.setUseDispersionCorrection(req(node, "dispersionCorrection",
                                             intbool))
        if node.get("includeDirectSpace") is not None:
            force.setIncludeDirectSpace(req(node, "includeDirectSpace",
                                            intbool))
        force.setPMEParameters(opt(node, "alpha", float, 0.0),
                               opt(node, "nx", int, 0),
                               opt(node, "ny", int, 0),
                               opt(node, "nz", int, 0))
        force.setLJPMEParameters(opt(node, "ljAlpha", float, 0.0),
                                 opt(node, "ljnx", int, 0),
                                 opt(node, "ljny", int, 0),
                                 opt(node, "ljnz", int, 0))
        force.setReciprocalSpaceForceGroup(opt(node, "recipForceGroup",
                                               int, -1))
        for p in child(node, "GlobalParameters"):
            force.addGlobalParameter(req(p, "name", str),
                                     req(p, "default", float))
        particle_offsets = []
        for o in child(node, "ParticleOffsets"):
            particle_offsets.append(
                (req(o, "parameter", str), req(o, "particle", int),
                 req(o, "q", float), req(o, "sig", float),
                 req(o, "eps", float)))
        exception_offsets = []
        for o in child(node, "ExceptionOffsets"):
            exception_offsets.append(
                (req(o, "parameter", str), req(o, "exception", int),
                 req(o, "q", float), req(o, "sig", float),
                 req(o, "eps", float)))
        force.setExceptionsUsePeriodicBoundaryConditions(
            req(node, "exceptionsUsePeriodic", intbool))
        for p in child(node, "Particles"):
            force.addParticle(req(p, "q", float), req(p, "sig", float),
                              req(p, "eps", float))
        for e in child(node, "Exceptions"):
            force.addException(req(e, "p1", int), req(e, "p2", int),
                               req(e, "q", float), req(e, "sig", float),
                               req(e, "eps", float))
        for args in particle_offsets:
            force.addParticleParameterOffset(*args)
        for args in exception_offsets:
            force.addExceptionParameterOffset(*args)
        for s in child(node, "Subsets"):
            force.setParticleSubset(req(s, "index", int),
                                    req(s, "subset", int))
        for s in child(node, "scalingParameters"):
            force.addScalingParameter(req(s, "parameter", str),
                                      req(s, "subset1", int),
                                      req(s, "subset2", int),
                                      req(s, "includeCoulomb", intbool),
                                      req(s, "includeLJ", intbool))
        for d in child(node, "energyParameterDerivatives"):
            force.addEnergyParameterDerivative(req(d, "parameter", str))
        return force
