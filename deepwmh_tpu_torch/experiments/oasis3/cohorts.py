"""OASIS-3 experiment cohorts: the exact accession lists the reference
ships (public OASIS-3 subject/session ids; the compatibility contract of
the experiment, like the CLI flags), the same lists as the JAX package's
``experiments/010_OASIS3/cohorts.py``:

- Siemens Biograph mMR: 10 healthy references + 100 WMH training subjects
  (the reference's experiments/010_OASIS3/run_Siemens_Biograph_mMR.py:61-121)
- Siemens TrioTim: 10 healthy references + 50 WMH training subjects
  (the reference's experiments/010_OASIS3/run_Siemens_TrioTim.py:60-103)

Each scanner entry carries (reference ids, reference descriptions,
training ids, training descriptions), index-aligned.
"""

MMR_REFERENCE = [
    "OAS30005_MR_d2384", "OAS30056_MR_d3491", "OAS30113_MR_d4437",
    "OAS30220_MR_d1165", "OAS30230_MR_d3855", "OAS30304_MR_d0027",
    "OAS30411_MR_d3025", "OAS30514_MR_d1526", "OAS30531_MR_d2584",
    "OAS30568_MR_d2326",
]

MMR_REFERENCE_DESC = [
    "HCwoWMH_female_54", "HCwoWMH_female_59", "HCwoWMH_male_65",
    "HCwoWMH_male_67", "HCwoWMH_female_56", "HCwoWMH_male_68",
    "HCwoWMH_male_55", "HCwoWMH_female_68", "HCwoWMH_female_59",
    "HCwoWMH_female_61",
]

MMR_TRAINING = [
    "OAS30003_MR_d3731", "OAS30006_MR_d3386", "OAS30010_MR_d0068",
    "OAS30011_MR_d1671", "OAS30026_MR_d0696", "OAS30039_MR_d0103",
    "OAS30050_MR_d1530", "OAS30066_MR_d2006", "OAS30071_MR_d0018",
    "OAS30080_MR_d1318", "OAS30089_MR_d0001", "OAS30098_MR_d0036",
    "OAS30105_MR_d0056", "OAS30117_MR_d4155", "OAS30123_MR_d0122",
    "OAS30134_MR_d1642", "OAS30155_MR_d0785", "OAS30167_MR_d1340",
    "OAS30208_MR_d1703", "OAS30212_MR_d3043", "OAS30257_MR_d3773",
    "OAS30263_MR_d2477", "OAS30272_MR_d3087", "OAS30279_MR_d0136",
    "OAS30281_MR_d0042", "OAS30291_MR_d1979", "OAS30307_MR_d2362",
    "OAS30315_MR_d0124", "OAS30318_MR_d3298", "OAS30346_MR_d1685",
    "OAS30350_MR_d1201", "OAS30355_MR_d0861", "OAS30364_MR_d0110",
    "OAS30369_MR_d5880", "OAS30391_MR_d1547", "OAS30403_MR_d2378",
    "OAS30407_MR_d2862", "OAS30414_MR_d0363", "OAS30438_MR_d2358",
    "OAS30464_MR_d2848", "OAS30468_MR_d0069", "OAS30475_MR_d0062",
    "OAS30486_MR_d1300", "OAS30515_MR_d0044", "OAS30516_MR_d4192",
    "OAS30527_MR_d0006", "OAS30535_MR_d1336", "OAS30538_MR_d0105",
    "OAS30558_MR_d4493", "OAS30567_MR_d0040", "OAS30574_MR_d1917",
    "OAS30577_MR_d0067", "OAS30580_MR_d1531", "OAS30585_MR_d0065",
    "OAS30587_MR_d4511", "OAS30589_MR_d3191", "OAS30590_MR_d0085",
    "OAS30592_MR_d0087", "OAS30607_MR_d0117", "OAS30637_MR_d0079",
    "OAS30663_MR_d0051", "OAS30685_MR_d1552", "OAS30691_MR_d0056",
    "OAS30706_MR_d0060", "OAS30723_MR_d2568", "OAS30728_MR_d0516",
    "OAS30735_MR_d3515", "OAS30746_MR_d0035", "OAS30749_MR_d1996",
    "OAS30762_MR_d1002", "OAS30808_MR_d3453", "OAS30812_MR_d0055",
    "OAS30827_MR_d1875", "OAS30839_MR_d1394", "OAS30841_MR_d3499",
    "OAS30852_MR_d6963", "OAS30858_MR_d2100", "OAS30867_MR_d4407",
    "OAS30896_MR_d3528", "OAS30910_MR_d1028", "OAS30950_MR_d0063",
    "OAS30978_MR_d0059", "OAS30982_MR_d1708", "OAS31006_MR_d0120",
    "OAS31012_MR_d4024", "OAS31013_MR_d0628", "OAS31015_MR_d0222",
    "OAS31019_MR_d1370", "OAS31028_MR_d1285", "OAS31037_MR_d6061",
    "OAS31041_MR_d1426", "OAS31042_MR_d3618", "OAS31048_MR_d2385",
    "OAS31054_MR_d2787", "OAS31071_MR_d0068", "OAS31090_MR_d3565",
    "OAS31096_MR_d1308", "OAS31115_MR_d0466", "OAS31127_MR_d2140",
    "OAS31150_MR_d1416",
]

MMR_TRAINING_DESC = [
    "WMH_female_68", "WMH_male_71", "WMH_female_68", "WMH_female_83",
    "WMH_male_82", "WMH_female_73", "WMH_female_74", "WMH_female_79",
    "WMH_male_72", "WMH_female_66", "WMH_male_78", "WMH_female_65",
    "WMH_female_69", "WMH_male_78", "WMH_male_74", "WMH_male_75",
    "WMH_female_71", "WMH_male_75", "WMH_female_80", "WMH_female_87",
    "WMH_male_77", "WMH_female_77", "WMH_female_74", "WMH_female_73",
    "WMH_male_73", "WMH_female_71", "WMH_male_83", "WMH_male_77",
    "WMH_male_72", "WMH_female_76", "WMH_female_83", "WMH_male_69",
    "WMH_male_71", "WMH_female_80", "WMH_male_87", "WMH_female_65",
    "WMH_female_83", "WMH_male_74", "WMH_female_79", "WMH_female_68",
    "WMH_female_74", "WMH_female_72", "WMH_male_58", "WMH_male_76",
    "WMH_female_78", "WMH_female_74", "WMH_female_55", "WMH_female_71",
    "WMH_female_76", "WMH_female_74", "WMH_female_77", "WMH_male_80",
    "WMH_male_71", "WMH_male_80", "WMH_female_76", "WMH_female_83",
    "WMH_male_58", "WMH_male_80", "WMH_female_86", "WMH_male_73",
    "WMH_female_69", "WMH_female_72", "WMH_female_69", "WMH_male_80",
    "WMH_male_76", "WMH_male_78", "WMH_female_66", "WMH_female_75",
    "WMH_male_78", "WMH_male_70", "WMH_female_90", "WMH_female_62",
    "WMH_male_77", "WMH_female_74", "WMH_male_87", "WMH_female_81",
    "WMH_female_75", "WMH_female_88", "WMH_male_91", "WMH_male_75",
    "WMH_male_65", "WMH_male_69", "WMH_female_78", "WMH_male_68",
    "WMH_female_79", "WMH_female_81", "WMH_male_86", "WMH_female_71",
    "WMH_female_70", "WMH_female_81", "WMH_male_81", "WMH_male_79",
    "WMH_male_62", "WMH_male_69", "WMH_male_74", "WMH_female_92",
    "WMH_male_85", "WMH_male_88", "WMH_female_86", "WMH_male_68",
]

TRIOTIM_REFERENCE = [
    "OAS30113_MR_d3502", "OAS30131_MR_d1901", "OAS30132_MR_d1392",
    "OAS30227_MR_d0000", "OAS30242_MR_d0137", "OAS30484_MR_d1065",
    "OAS30531_MR_d0108", "OAS31103_MR_d1829", "OAS30499_MR_d1164",
    "OAS31047_MR_d1165",
]

TRIOTIM_REFERENCE_DESC = [
    "HCwoWMH_male_62", "HCwoWMH_male_54", "HCwoWMH_male_71",
    "HCwoWMH_female_58", "HCwoWMH_female_65", "HCwoWMH_female_64",
    "HCwoWMH_female_52", "HCwoWMH_female_60", "HCwoWMH_female_60",
    "HCwoWMH_female_70",
]

TRIOTIM_TRAINING = [
    "OAS30027_MR_d2394", "OAS30074_MR_d1871", "OAS30080_MR_d0048",
    "OAS30092_MR_d3727", "OAS30142_MR_d1279", "OAS30146_MR_d3322",
    "OAS30175_MR_d3219", "OAS30198_MR_d0083", "OAS30204_MR_d0020",
    "OAS30232_MR_d2324", "OAS30246_MR_d1591", "OAS30283_MR_d0797",
    "OAS30335_MR_d2770", "OAS30342_MR_d0001", "OAS30357_MR_d1195",
    "OAS30369_MR_d5872", "OAS30403_MR_d1232", "OAS30414_MR_d1175",
    "OAS30443_MR_d2432", "OAS30487_MR_d1338", "OAS30492_MR_d0090",
    "OAS30535_MR_d0139", "OAS30559_MR_d2422", "OAS30589_MR_d1525",
    "OAS30596_MR_d2477", "OAS30612_MR_d0039", "OAS30615_MR_d2022",
    "OAS30625_MR_d0033", "OAS30685_MR_d0032", "OAS30710_MR_d2323",
    "OAS30713_MR_d2308", "OAS30735_MR_d2484", "OAS30743_MR_d2309",
    "OAS30755_MR_d1540", "OAS30757_MR_d2279", "OAS30765_MR_d2798",
    "OAS30818_MR_d1214", "OAS30857_MR_d2255", "OAS30869_MR_d2290",
    "OAS30876_MR_d1670", "OAS30899_MR_d2324", "OAS30975_MR_d0008",
    "OAS30978_MR_d1207", "OAS31006_MR_d1106", "OAS31019_MR_d0076",
    "OAS31034_MR_d0203", "OAS31058_MR_d3519", "OAS31060_MR_d0083",
    "OAS31092_MR_d3113", "OAS31168_MR_d1566",
]

TRIOTIM_TRAINING_DESC = [
    "WMH_male_75", "WMH_female_76", "WMH_female_62", "WMH_female_68",
    "WMH_male_69", "WMH_female_77", "WMH_female_81", "WMH_male_88",
    "WMH_male_69", "WMH_female_72", "WMH_female_77", "WMH_female_76",
    "WMH_female_73", "WMH_male_79", "WMH_male_76", "WMH_female_80",
    "WMH_female_61", "WMH_male_76", "WMH_male_74", "WMH_female_75",
    "WMH_male_57", "WMH_female_52", "WMH_male_74", "WMH_female_78",
    "WMH_female_79", "WMH_female_64", "WMH_male_73", "WMH_male_68",
    "WMH_female_68", "WMH_female_71", "WMH_male_76", "WMH_female_64",
    "WMH_male_78", "WMH_female_71", "WMH_male_69", "WMH_female_74",
    "WMH_male_73", "WMH_male_56", "WMH_female_73", "WMH_female_67",
    "WMH_male_81", "WMH_male_82", "WMH_male_72", "WMH_male_71",
    "WMH_female_67", "WMH_male_67", "WMH_male_69", "WMH_male_77",
    "WMH_male_80", "WMH_male_69",
]

COHORTS = {
    "mMR": {
        "experiment_name": "Siemens_Biograph_mMR",
        "reference": MMR_REFERENCE,
        "reference_desc": MMR_REFERENCE_DESC,
        "training": MMR_TRAINING,
        "training_desc": MMR_TRAINING_DESC,
    },
    "TrioTim": {
        "experiment_name": "Siemens_TrioTim",
        "reference": TRIOTIM_REFERENCE,
        "reference_desc": TRIOTIM_REFERENCE_DESC,
        "training": TRIOTIM_TRAINING,
        "training_desc": TRIOTIM_TRAINING_DESC,
    },
}
